"""`--quant int8` for the serving tier (the port of sheeprl_tpu/serve/quant.py):
calibration, quality-receipt rung acceptance, and quantized dispatch.

  - `ops/quant.py` calibrates per-channel activation scales on seeded
    batches (or loads the `quant_scales.npz` persisted beside a checkpoint)
    and returns a copy of the served actor with its `Linear`s swapped for
    `QuantLinear`s;
  - each ladder rung is then timed through `compile/decisions.py:decide`,
    each candidate graphed as the rung serves it (`compile/plan.py:graphed`),
    under bounded-divergence acceptance: int8 wins a rung only when it is
    faster AND its max action divergence on the held-out set stays within
    `--quant_bound`; past the bound it is disqualified and the rung keeps
    serving f32, so the ladder can be mixed;
  - DreamerV3 calibrates through the served player step
    (`DV3ServePolicy.step`) on seeded batches of (state rows, obs): the
    state rows are the params' init row repeated, the obs synthetic (uniform
    bytes for uint8 spaces, unit normals for float ones). Its int8 rungs
    dispatch the quantized twin through `policy.step`: the GRU (kernel 1)
    and the encoder's convs (kernel 3) run in the twin as in the f32
    player, inside each rung's graph;
  - the SAC trunk dispatches through the fused kernel
    (`ops/kernels/int8_trunk.py:fused_int8_trunk`, `csrc/int8_trunk.cu`)
    when the trunk's structure matches (two biased ReLU QuantLinears, no
    norms, a QuantLinear mean head) and its weights pass the reference's
    10 MiB guard. The kernel computes `QuantLinear`'s own arithmetic, so a
    receipt measured on either path holds for both.

The port has no `use_pallas` switch: the kernel's wrapper decides by the
tensors' device (the kernel on CUDA, its plain version on the CPU), so
`Serve/quant_fused` reads 1 on either device wherever the structure
matches. The reference reads 0 off the TPU, where its gate is off.

Which Linears a DreamerV3 calibration records depends, in the reference,
on its Pallas gate: with the gate on (the TPU path) the GRU cell takes its
kernel branch, which reads `rssm.recurrent_model.rnn.proj.weight` and never
calls the Linear, so that Linear gets no scale and stays f32 (10 scales at
the default structure); with the gate off (its plain CPU path) the cell
calls it and it is quantized too (11). The port's cell takes the kernel
branch by structure on either device, so its calibration covers the gated
reference's 10, and a `quant_scales.npz` the reference wrote on that path
loads here unchanged (ROADMAP Queue C: a finding in the reference,
mirrored, not fixed).

A hot reload re-derives the scales for the new params version in the
reload thread (the ParamsStore `on_reload` hook; `Serve/quant_rederives`
counts them), so the dispatch path never pays a calibration; version N's
quantized params keep serving until the rebuild lands.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.nn as tnn

from ..compile.decisions import tree_leaves
from ..compile.plan import graphed
from ..ops.kernels.int8_trunk import fused_int8_trunk, fused_int8_trunk_supported
from ..ops.precision import compute_dtype

__all__ = ["QuantState", "action_divergence"]

_CALIB_BATCHES = 4
_CALIB_ROWS = 64
# The reference's offset, kept for parity: its held-out draws are NOT new,
# since calibration draws seeds seed+0..3, so the receipt set at rung r is
# the first r rows of calibration batch 1 (ROADMAP Queue C).
_HELD_OUT_SEED_OFFSET = 1


def action_divergence(a: Any, b: Any) -> float:
    """Quality metric for `decide`: max elementwise |delta| over the two
    step outputs (tensors, or lists / tuples / dicts of them: DreamerV3's
    (state dict, actions), so the recurrent state counts)."""
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def _synth_obs(space, rng: np.random.Generator, rows: int) -> np.ndarray:
    """Seeded synthetic observations matching a space: uniform bytes for
    image (uint8) spaces, unit normals for float vectors."""
    shape = (rows,) + tuple(space.shape)
    dt = np.dtype(space.dtype)
    if dt == np.uint8:
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(dt)


class QuantState:
    """Everything `--quant int8` adds to a serve process: scale derivation
    and persistence, per-version quantized params, per-rung quality-receipt
    decisions, and the `Serve/quant_*` gauges."""

    def __init__(self, policy, args, log_dir: str, telem: Any = None):
        self.policy = policy
        self.bound = float(args.quant_bound)
        self.telem = telem
        self.seed = int(getattr(args, "seed", 0) or 0)
        self.ckpt = args.ckpt
        self.store_path = os.path.join(log_dir, "serve_quant.json")
        self.available = True  # flips off when calibration cannot run
        self.int8_rungs: set[int] = set()
        self.rederives = 0
        self.decisions: dict[int, Any] = {}
        self._cache: tuple[int, Any] | None = None  # (version, qparams)
        # the reload hook and an int8 dispatch can race to derive the same
        # version; serialize so only one pays the calibration
        self._derive_lock = threading.Lock()
        self._step_int8: Callable | None = None
        self._fused = False

    # ---- calibration + quantization ---------------------------------------
    def _calib_inputs(self, version: int, params, rows: int, seed: int) -> tuple:
        """One seeded batch of step inputs (minus params) on the policy's
        device: SAC takes a bare obs matrix, DreamerV3 (state rows, obs
        dict), the rows its params' init row and the obs `_synth_obs`'s,
        drawn in `obs_keys` order from one generator."""
        rng = np.random.default_rng(seed)
        device = self.policy.device
        if self.policy.algo == "sac":
            obs = rng.standard_normal((rows, self.policy.obs_dim)).astype(np.float32)
            return (torch.from_numpy(obs).to(device),)
        row = self.policy.init_row(version, params)
        with torch.no_grad():
            state = {k: torch.stack([v] * rows) for k, v in row.items()}
        obs = {k: torch.from_numpy(_synth_obs(self.policy.obs_space[k], rng, rows)).to(device)
               for k in self.policy.obs_keys}
        return (state, obs)

    def _calibrate(self, version: int, params) -> dict[str, np.ndarray]:
        from ..ops import quant as q

        batches = [self._calib_inputs(version, params, _CALIB_ROWS, self.seed + i) for i in range(_CALIB_BATCHES)]
        if self.policy.algo == "sac":
            return q.calibrate(params, lambda m, b: m.get_greedy_actions(b[0]), batches)
        return q.calibrate(params, lambda m, b: self.policy.step(m, *b), batches)

    def _scales_for(self, version: int, params) -> dict[str, np.ndarray] | None:
        """Persisted scales for the first version when available, freshly
        derived (and persisted, when serving a checkpoint) otherwise."""
        from ..ops import quant as q

        persisted = None
        if self.ckpt and version <= 1:
            persisted = q.load_scales(q.scales_path(self.ckpt))
        if persisted:
            self._event("serve.quant_scales", source="persisted", version=version)
            return persisted
        try:
            scales = self._calibrate(version, params)
        except Exception as err:
            self._event(
                "serve.quant_scales", source="error", version=version,
                error=f"{type(err).__name__}: {err}"[:200],
            )
            return None
        if not scales:
            return None
        if self.ckpt:
            try:
                q.save_scales(q.scales_path(self.ckpt), scales)
            except OSError:
                pass  # persistence is an optimization, never fatal
        self._event("serve.quant_scales", source="calibrated", version=version, linears=len(scales))
        return scales

    def params_for(self, version: int, params):
        """The quantized twin of `params`, cached per version. A version
        bump (hot reload) re-derives scales and re-quantizes: the swap
        changed the weights, so the old scales no longer describe the
        activations."""
        from ..ops import quant as q

        if self._cache is not None and self._cache[0] == version:
            return self._cache[1]
        with self._derive_lock:
            if self._cache is not None and self._cache[0] == version:
                return self._cache[1]
            if self._cache is not None:
                self.rederives += 1
            scales = self._scales_for(version, params)
            if scales is None:
                self.available = False
                return params
            qparams = q.quantize_linears(params, scales)
            self._cache = (version, qparams)
            return qparams

    # ---- the int8 step (fused kernel when the trunk matches) ---------------
    def step_for(self, qparams) -> Callable:
        """The step the int8 rungs dispatch through: the fused SAC trunk
        when the structure and the guard allow, else the policy's own step
        (the QuantLinear path)."""
        if self._step_int8 is not None:
            return self._step_int8
        self._fused = _sac_fused_ready(self.policy, qparams)
        self._step_int8 = _make_fused_sac_step() if self._fused else self.policy.step
        return self._step_int8

    # ---- per-rung quality-receipt acceptance -------------------------------
    def accept_rungs(self, version: int, params, rungs: list[int]) -> set[int]:
        """Run the bounded-divergence ladder for every serve rung:
        candidates [f32, int8] timed through `decide` with the max action
        divergence on the held-out set as the quality metric. Returns the
        rungs where int8 won; the decision records (receipts) land in
        `serve_quant.json` and `self.decisions`. A candidate that raises
        (the int8 kernel failing to build or launch) raises out of here:
        only a measured divergence past the bound keeps a rung on f32."""
        from ..compile import decisions as dec

        qparams = self.params_for(version, params)
        if not self.available:
            return set()
        step_f32 = self.policy.step
        step_int8 = self.step_for(qparams)
        won: set[int] = set()
        for rung in rungs:
            # the held-out states are the receipt set: both candidates run
            # on them, so the measured divergence is the committed receipt
            example = self._calib_inputs(version, params, rung, self.seed + _HELD_OUT_SEED_OFFSET)

            def build(label, _p=params, _q=qparams, _r=rung):
                # each candidate as the rung would serve it: one CUDA graph
                # on the card (compile/plan.py), timed by its replays
                if label == "int8":
                    step = lambda *a: step_int8(_q, *a)  # noqa: E731
                else:
                    step = lambda *a: step_f32(_p, *a)  # noqa: E731
                return graphed(f"decide_{label}_b{_r}", step, self.policy.device, self.telem)

            d = dec.decide(
                "serve_quant",
                # the bound is part of the name: a tight-bound re-run
                # must re-measure, never inherit a loose-bound winner
                f"policy_b{rung}@{self.bound:g}",
                ["f32", "int8"],
                build,
                example,
                quality_metric=action_divergence,
                quality_bound=self.bound,
                store_path=self.store_path,
            )
            self.decisions[rung] = d
            if d.winner == "int8":
                won.add(rung)
            rep = d.candidate("int8")
            self._event(
                "serve.quant_rung", rung=rung, accepted=d.winner == "int8",
                divergence=rep.get("divergence"), bound=self.bound,
                within_bound=rep.get("within_bound"), fused=self._fused,
                source=d.source,
            )
        self.int8_rungs = won
        return won

    # ---- observability -----------------------------------------------------
    def gauges(self) -> dict[str, float]:
        worst = 0.0
        for rung in self.int8_rungs:
            d = self.decisions.get(rung)
            if d is not None:
                div = d.candidate("int8").get("divergence")
                if div is not None:
                    worst = max(worst, float(div))
        return {
            "Serve/quant_enabled": 1.0 if self.available else 0.0,
            "Serve/quant_rungs": float(len(self.int8_rungs)),
            "Serve/quant_bound": self.bound,
            "Serve/quant_divergence_max": worst,
            "Serve/quant_rederives": float(self.rederives),
            "Serve/quant_fused": 1.0 if self._fused else 0.0,
        }

    def _event(self, name: str, **data: Any) -> None:
        if self.telem is not None:
            try:
                self.telem.event(name, **data)
            except Exception:  # telemetry must not break serving
                pass


# ---------------------------------------------------------------------------
# fused SAC trunk dispatch
# ---------------------------------------------------------------------------


def _sac_fused_ready(policy, actor) -> bool:
    """Structural guard for the fused kernel: SAC, a 2-layer biased ReLU
    trunk with no norms (an `Identity` in each norm slot) and no MLP head,
    every trunk weight quantized, and the quantized weight set within the
    reference's 10 MiB guard."""
    from ..ops.quant import QuantLinear

    if getattr(policy, "algo", None) != "sac":
        return False
    model = getattr(actor, "model", None)
    fc_mean = getattr(actor, "fc_mean", None)
    if model is None or fc_mean is None:
        return False
    if model.act != "relu" or model.head is not None:
        return False
    if len(model.layers) != 2 or not all(isinstance(n, tnn.Identity) for n in model.norms):
        return False
    parts = [*model.layers, fc_mean]
    if not all(isinstance(p, QuantLinear) and p.bias is not None for p in parts):
        return False
    weights = [a for p in parts for a in (p.w_q, p.w_scale, p.in_scale, p.bias)]
    return fused_int8_trunk_supported(*weights)


def _make_fused_sac_step() -> Callable:
    """The fused-kernel twin of `SACServePolicy.step`: the same signature
    (actor, obs) -> actions, the same pre-cast through the trunk's compute
    dtype, the same f32 tanh squash outside the kernel; only the trunk runs
    through `fused_int8_trunk` instead of three QuantLinears."""

    def step(actor, obs):
        x = obs.to(compute_dtype(actor.compute_dtype)).float()
        l0, l1, m = actor.model.layers[0], actor.model.layers[1], actor.fc_mean
        mean = fused_int8_trunk(
            x,
            l0.in_scale, l0.w_q, l0.w_scale, l0.bias,
            l1.in_scale, l1.w_q, l1.w_scale, l1.bias,
            m.in_scale, m.w_q, m.w_scale, m.bias,
        )
        return torch.tanh(mean) * actor.action_scale + actor.action_bias

    return step
