#!/usr/bin/env python3
"""Kernel 8 of the PyTorch/CUDA port (symlog/symexp) in this checkout
against the same kernel in another checkout of the port, on one card.

Each checkout's kernel is built from its own `csrc/symlog.cu` and called
through its own `ops/kernels/symlog.py`, so two checkouts compare whatever
the kernel's C interface was in each. Unpack the other commit into a
directory git ignores, then run from the root of this checkout:

    mkdir -p build/earlier && git archive <commit> | tar -x -C build/earlier
    python3 tools/torch_symlog_ab.py --earlier build/earlier

For each function, dtype and shape ([65,536, 1,024], where the bytes set
the time, and [1,024, 255], the two-hot logits' shape) both run on the same
input; their outputs must be equal bit for bit. Each is timed by
`chip_smoke.py:device_ms_run` in turns: earlier, this, this, earlier. One
JSON line a case, then the card's name and power limit. Exits non-zero
without a card or when the outputs differ.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "sheeprl_tpu_torch"
SHAPES = ((65536, 1024), (1024, 255))


def symlog_module(root: str):
    """`ops/kernels/symlog.py` of the checkout at `root`, imported apart
    from any other checkout's (its package leaves sys.modules after the
    import; the module keeps what it imported)."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k == PKG or k.startswith(PKG + ".")}
    sys.path.insert(0, os.path.abspath(root))
    try:
        return importlib.import_module(PKG + ".ops.kernels.symlog")
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules if k == PKG or k.startswith(PKG + ".")]:
            del sys.modules[k]
        sys.modules.update(saved)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--earlier", required=True, help="root of the other checkout of the port")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_symlog_ab: FAIL: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import HBM_BYTES_PER_S, device_ms_run, smi_line

    earlier, this = symlog_module(args.earlier), symlog_module(HERE)
    gen = torch.Generator().manual_seed(0)
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            x = (20.0 * torch.randn(*shape, generator=gen)).to("cuda", dtype)
            for name in ("symlog", "symexp"):
                old, new = getattr(earlier, name), getattr(this, name)
                equal = bool(torch.equal(old(x), new(x)))
                ok = ok and equal
                times = [device_ms_run(torch, lambda f=f: f(x)) for f in (old, new, new, old)]
                nbytes = 2 * x.numel() * x.element_size()
                print(json.dumps(dict(kernel=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
                                      earlier_run_ms=[times[0], times[3]], run_ms=[times[1], times[2]],
                                      bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, outputs_equal=equal)), flush=True)
    print(smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
