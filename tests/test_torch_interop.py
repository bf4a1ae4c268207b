"""Carrying the reference's parameters into the port (`interop.py`): a tiny
DreamerV3 player round-trips with no leftover on either side, and every
mismatch raises with the path named.

Also holds the helpers the other port tests share: `jax_flat` flattens a
JAX module pytree into {field path: numpy array}, and `tiny_players`
builds the same tiny player on both sides."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

# the reference's player at tiny widths: pixels + one vector key, discrete actions
TINY_DV3 = dict(
    cnn_channels_multiplier=2,
    dense_units=16,
    recurrent_state_size=16,
    hidden_size=16,
    stochastic_size=4,
    discrete_size=4,
    mlp_layers=2,
)


def jax_flat(tree) -> dict[str, np.ndarray]:
    """A JAX module pytree -> {dotted field path: numpy array}."""
    import jax

    def part(k) -> str:
        for attr in ("name", "idx", "key"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(f"unexpected pytree key {k!r}")

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(part(k) for k in path): np.asarray(leaf) for path, leaf in leaves}


@functools.cache
def tiny_players(seed: int = 0, actions_dim=(3,), image=(64, 64, 3), vector: int = 5):
    """(jax_player, torch_player) of one tiny DreamerV3 configuration, the
    port's weights carried across from the reference's. Cached: callers
    must not change the players."""
    import gymnasium as gym
    import jax

    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerDV3 as JaxPlayer
    from sheeprl_tpu.algos.dreamer_v3.agent import build_models as jax_build
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args as JaxArgs
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3, build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop import load_jax_params

    cnn_keys, mlp_keys = ["rgb"], ["state"]
    jargs = JaxArgs(**TINY_DV3)
    jspace = {
        "rgb": gym.spaces.Box(0, 255, image, np.uint8),
        "state": gym.spaces.Box(-np.inf, np.inf, (vector,), np.float32),
    }
    wm, jactor, _, _ = jax_build(
        jax.random.PRNGKey(seed), list(actions_dim), False, jargs, jspace, cnn_keys, mlp_keys
    )
    common = dict(
        stochastic_size=TINY_DV3["stochastic_size"],
        discrete_size=TINY_DV3["discrete_size"],
        recurrent_state_size=TINY_DV3["recurrent_state_size"],
        is_continuous=False,
    )
    jplayer = JaxPlayer(
        encoder=wm.encoder, rssm=wm.rssm, actor=jactor, actions_dim=tuple(actions_dim), **common
    )
    targs = DreamerV3Args(**TINY_DV3)
    tspace = {"rgb": spaces.Box(0, 255, image, np.uint8), "state": spaces.Box(-np.inf, np.inf, (vector,))}
    encoder, rssm, actor = build_models(
        torch.Generator().manual_seed(seed), list(actions_dim), False, targs, tspace, cnn_keys, mlp_keys
    )
    tplayer = PlayerDV3(encoder, rssm, actor, actions_dim=actions_dim, **common)
    load_jax_params(tplayer, jax_flat(jplayer))
    return jplayer, tplayer


def test_tiny_player_round_trips_without_leftovers():
    from sheeprl_tpu_torch.interop import state_dict_from_jax

    jplayer, tplayer = tiny_players()
    flat = jax_flat(jplayer)
    sd = tplayer.state_dict()
    assert set(flat) == set(sd)
    for name, value in sd.items():
        want = flat[name].T if name.endswith(".weight") and flat[name].ndim == 2 else flat[name]
        np.testing.assert_array_equal(value.numpy(), want, err_msg=name)
    # the GRU weight is the biggest transposed leaf: [in, out] -> [out, in]
    w = flat["rssm.recurrent_model.rnn.proj.weight"]
    assert tuple(sd["rssm.recurrent_model.rnn.proj.weight"].shape) == (w.shape[1], w.shape[0])
    # conv kernels stay HWIO
    k = flat["encoder.cnn_encoder.model.layers.0.kernel"]
    assert tuple(sd["encoder.cnn_encoder.model.layers.0.kernel"].shape) == k.shape
    again = state_dict_from_jax(tplayer, flat)
    assert set(again) == set(sd)


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_interop_raises_naming_the_path(fault):
    from sheeprl_tpu_torch.interop import state_dict_from_jax

    jplayer, tplayer = tiny_players()
    flat = jax_flat(jplayer)
    if fault == "extra":
        path = "rssm.recurrent_model.rnn.proj.bias"
        flat[path] = np.zeros(48, np.float32)
        err = KeyError
    elif fault == "missing":
        path = "actor.heads.0.bias"
        del flat[path]
        err = KeyError
    else:
        path = "encoder.cnn_encoder.model.norms.1.scale"
        flat[path] = np.ones(3, np.float32)
        err = ValueError
    with pytest.raises(err, match=path.replace(".", r"\.")):
        state_dict_from_jax(tplayer, flat)


def test_nested_dict_input_is_flattened():
    from sheeprl_tpu_torch.interop import flatten_params

    nested = {"a": {"b": np.ones(2), "c": {"d": np.zeros(1)}}, "e": np.ones(3)}
    assert sorted(flatten_params(nested)) == ["a.b", "a.c.d", "e"]
