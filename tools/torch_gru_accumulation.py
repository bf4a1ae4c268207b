#!/usr/bin/env python3
"""The f32 accumulation of csrc/ln_gru.cu's projection (kernels 1 and 2),
three ways, each against a float64 oracle beside the plain version, at the
cases of `tests/test_torch_cuda.py::test_gru_kernels_against_a_float64_oracle`,
and timed at DreamerV3's width (kernel 1 at B 1 and 8, kernel 2 at B 16 and
1,024; an event pair around 60 launches):

  - "per_step", the source as it stands: each k8 step's three TF32
    products into a zeroed accumulator, added to the running sums with
    round-to-nearest adds;
  - "chained": the running sums carried through every MMA (the kernel
    before the repair; the tensor core truncates its f32 sum toward zero);
  - "ffma": the projection on the CUDA cores, one fused multiply-add a
    product (cuBLAS's f32 arithmetic), no tensor core.

Each variant is the source with its k loop's body replaced, built with
the package's nvcc flags into build/gru_accumulation/. For each case and
quantity it prints the kernel's largest and mean absolute errors over the
plain version's, both biases, and their gap in standard errors and in f32
ulps of the quantity; `ok` is the oracle test's check. Run from the root of
a checkout, on one card:

    python3 tools/torch_gru_accumulation.py [--out DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the f32 k loop of the projection, from its first line to its end
LOOP_BEGIN = "#pragma unroll\n      for (int kk = 0; kk < kBK; kk += 8) {\n        uint32_t ah[kMT][4]"
LOOP_END = "            for (int q = 0; q < 4; ++q) acc[i][j][q] += step[i][j][q];\n      }\n"
STEP_BEGIN = "        float step[kMT][kNT][4];\n"
CHAINED = """#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
      }
"""
FFMA = """      const float* af = reinterpret_cast<const float*>(as);
      const float* wf = reinterpret_cast<const float*>(ws);
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kMT][2], wv[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          av[i][0] = af[(row0 + 16 * i + g) * kLd + kk];
          av[i][1] = af[(row0 + 16 * i + g + 8) * kLd + kk];
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          wv[j][0] = wf[(col0 + 8 * j + 2 * t) * kLd + kk];
          wv[j][1] = wf[(col0 + 8 * j + 2 * t + 1) * kLd + kk];
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = fmaf(av[i][q / 2], wv[j][q % 2], acc[i][j][q]);
      }
"""


def variant_source(src: str, name: str) -> str:
    """The kernel source with its f32 k loop's accumulation as `name`."""
    begin, end = src.index(LOOP_BEGIN), src.index(LOOP_END) + len(LOOP_END)
    if name == "per_step":
        return src
    if name == "chained":
        step = src.index(STEP_BEGIN, begin)
        return src[:step] + CHAINED + src[end:]
    if name == "ffma":
        return src[:begin] + FFMA + src[end:]
    raise ValueError(name)


VARIANTS = ("chained", "per_step", "ffma")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(HERE, "build", "gru_accumulation"))
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_gru_accumulation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import tests.test_torch_cuda as T
    from sheeprl_tpu_torch.ops.kernels import build, gru

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(opts.out, exist_ok=True)
    src = (build.CSRC_DIR / "ln_gru.cu").read_text()
    procs = {}
    for name in VARIANTS:
        path = os.path.join(opts.out, f"ln_gru_{name}.cu")
        with open(path, "w") as fh:
            fh.write(variant_source(src, name))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}", "-o",
               os.path.join(opts.out, f"libln_gru_{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    funcs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        fn = ctypes.CDLL(os.path.join(opts.out, f"libln_gru_{name}.so")).ln_gru_forward
        fn.argtypes, fn.restype = gru._ARGTYPES, ctypes.c_int
        funcs[name] = fn

    def stats(name: str) -> dict:
        gru.bind = lambda *a, **k: funcs[name]
        out = {}
        for batch, hidden, draws in T.GRU_ORACLE_CASES:
            gen = torch.Generator().manual_seed(batch * 7 + hidden)
            errs: dict = {}
            mags: dict = {}

            def add(q, side, got, want):
                errs.setdefault(q, {}).setdefault(side, []).append((got.double() - want).flatten())
                mags.setdefault(q, []).append(want.abs().mean())

            for _ in range(draws):
                x = T._rand(gen, batch, hidden).to(dev)
                h = torch.tanh(T._rand(gen, batch, hidden)).to(dev)
                w = T._rand(gen, 3 * hidden, 2 * hidden, scale=(2 * hidden) ** -0.5).to(dev)
                scale = (1.0 + T._rand(gen, 3 * hidden, scale=0.1)).to(dev)
                offset = T._rand(gen, 3 * hidden, scale=0.1).to(dev)
                g = T._rand(gen, batch, hidden).to(dev)
                args = (x, h, w, scale, offset, 1e-5)
                args64 = tuple(a.double() for a in args[:5]) + (1e-5,)
                with torch.no_grad():
                    want = T._gru_float64(*args64)
                    for q, got, plain, oracle in zip(("h'", "hat", "rstd"), gru.layernorm_gru_cell_residuals(*args),
                                                     gru.layernorm_gru_cell_residuals_plain(*args), want):
                        add(q, "kernel", got, oracle)
                        add(q, "plain", plain, oracle)
                want_grads = T._gru_grads(lambda *a: T._gru_float64(*a)[0], args64, g.double())
                for side, fn in (("kernel", gru.layernorm_gru_cell), ("plain", gru.layernorm_gru_cell_plain)):
                    for q, got, oracle in zip(T.GRU_GRADS, T._gru_grads(fn, args, g), want_grads):
                        add(q, side, got, oracle)
            for q, sides in errs.items():
                k, p = torch.cat(sides["kernel"]), torch.cat(sides["plain"])
                diff = torch.stack([e.mean() for e in sides["kernel"]]) - torch.stack([e.mean() for e in sides["plain"]])
                se = float(diff.std() / len(diff) ** 0.5)
                gap = abs(float(diff.mean()))
                ulp = torch.finfo(torch.float32).eps * float(torch.stack(mags[q]).mean())
                row = dict(max_x=float(k.abs().max() / p.abs().max()), mean_x=float(k.abs().mean() / p.abs().mean()),
                           bias_kernel=float(k.mean()), bias_plain=float(p.mean()), gap_se=gap / se if se else 0.0,
                           gap_ulp=gap / ulp)
                row["ok"] = row["max_x"] <= 2 and row["mean_x"] <= 2 and gap <= max(
                    5 * se, 0.01 * float(p.abs().mean()), ulp)
                out[f"B={batch} H={hidden} {q}"] = row
        return out

    def times(name: str) -> dict:
        gru.bind = lambda *a, **k: funcs[name]
        out = {}
        gen = torch.Generator().manual_seed(0)
        for kernel, batch in (("kernel 1", 1), ("kernel 1", 8), ("kernel 2", 16), ("kernel 2", 1024)):
            x = T._rand(gen, batch, 512).to(dev)
            h = torch.tanh(T._rand(gen, batch, 512)).to(dev)
            w = T._rand(gen, 1536, 1024, scale=1024 ** -0.5).to(dev)
            ones, zeros = torch.ones(1536, device=dev), torch.zeros(1536, device=dev)
            fn = gru.layernorm_gru_cell if kernel == "kernel 1" else gru.layernorm_gru_cell_residuals
            for _ in range(10):
                fn(x, h, w, ones, zeros)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(60):
                fn(x, h, w, ones, zeros)
            end.record()
            torch.cuda.synchronize()
            out[f"{kernel} B={batch}"] = start.elapsed_time(end) / 60
        return out

    report = {}
    for name in VARIANTS:
        st, tm = stats(name), times(name)
        report[name] = dict(stats=st, ms=tm)
        failing = [k for k, v in st.items() if not v["ok"]]
        print(f"[gru-accumulation] {name}: ms {json.dumps({k: round(v, 5) for k, v in tm.items()})}; "
              f"{len(failing)} of {len(st)} checks failing: {failing}", flush=True)
        for k, v in st.items():
            print(f"[gru-accumulation]   {name} {k}: max x{v['max_x']:.2f} mean x{v['mean_x']:.2f} bias kernel "
                  f"{v['bias_kernel']:+.3e} plain {v['bias_plain']:+.3e} gap {v['gap_se']:.1f} s.e. "
                  f"{v['gap_ulp']:.2f} ulp", flush=True)
    with open(os.path.join(opts.out, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
