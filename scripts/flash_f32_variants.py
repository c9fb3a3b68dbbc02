"""Times the float32 flash kernels (``csrc/flash_attention_tf32.cuh``, route
``tf32x3``) as built against copies that each undo one of their design
choices, on one CUDA card.

    python3 scripts/flash_f32_variants.py

Each copy (``UNDONE``) replaces exact text of the header: the TF32 rounding
by the ``cvt.rna.tf32.f32`` instruction instead of two integer operations;
the backward at head_dim 64 on one warp a key group instead of two; split
key groups that both form S^T and dP^T instead of exchanging them; the
forward's score loop, the backward's S^T / dP^T loop and the band product's
depth loop unrolled in full instead of by 4. The copies are built under
``build/flash_variants/`` (one nvcc each, at once); any edit to the replaced
text stops the script with an ``AssertionError`` until ``UNDONE`` follows
it. Every library is first held to the plain version by phase 4's rule
(``chip_smoke.flash_case``) at head_dim 64 and 128 with the band and
dropout 0.1. Then each (head_dim, bias, dropout) at the main path's shape
(``chip_smoke.FLASH_TIMED``) is timed with CUDA events over 10 launches a
direction, in turns: as built, each copy, as built again. Prints ptxas'
registers and spills per kernel, one line per case, and the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from composer_tpu_torch.ops import _build  # noqa: E402
from composer_tpu_torch.ops import flash_attention as fa  # noqa: E402

HEADER = "flash_attention_tf32.cuh"
# name -> ((as built, undone), ...) in HEADER.
UNDONE = {
    "cvt rounding": (("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                      '  unsigned r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
                      "  return r;"),),
    "one warp a key group at D=64": (("  return D >= 64 ? 2 : 1;", "  return D > 64 ? 2 : 1;"),),
    "no exchange": (("  return bwd_f32_split<D>() == 2 &&\n",
                     "  return false && bwd_f32_split<D>() == 2 &&\n"),),
    "forward scores unrolled in full": (
        ("#pragma unroll 4  // in full, 1.18-1.21x the time at D=128 (PERF.md)",
         "#pragma unroll"),),
    "backward S^T, dP^T unrolled in full": (
        ("#pragma unroll 4  // in full, 1.19-1.26x the time at D=64, 1.56-1.60x at D=128 "
         "(PERF.md)", "#pragma unroll"),),
    "band product unrolled in full": (
        ("  float acc[N1 - N0][4] = {};\n#pragma unroll 4\n",
         "  float acc[N1 - N0][4] = {};\n#pragma unroll\n"),),
}


def build(name: str, edits) -> tuple:
    """The flash library built from a copy of csrc/ with ``edits``; returns
    ``(library, ptxas lines of the float32 kernels)``."""
    csrc = ROOT / "build" / "flash_variants" / re.sub(r"\W+", "_", name) / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    text = (csrc / HEADER).read_text()
    for built, undone in edits:
        if text.count(built) != 1:
            raise AssertionError(f"{name}: {built!r} no longer reads as expected")
        text = text.replace(built, undone)
    (csrc / HEADER).write_text(text)
    target = csrc.parent / "libflash_attention.so"
    result = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target),
                             str(csrc / "flash_attention.cu")], capture_output=True, text=True)
    if result.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{result.stderr}")
    library = ctypes.CDLL(str(target))
    for symbol, argtypes in _build.ENTRY_POINTS["flash_attention"].items():
        getattr(library, symbol).restype = ctypes.c_int
        getattr(library, symbol).argtypes = argtypes
    lines = (result.stdout + result.stderr).splitlines()
    ptxas = []
    for i, line in enumerate(lines):
        found = re.search(r"flash_(forward|backward)_tf32_kernelILi(\d+)E", line)
        if found and "Compiling entry" in line:
            ptxas.append(f"{found.group(1)} D={found.group(2)}: {lines[i + 2].strip()}; "
                         f"{lines[i + 3].split(':', 1)[1].strip()}")
    return library, sorted(ptxas)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_variants.py needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    variants = {"as built": ()} | UNDONE
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(lambda item: build(*item), variants.items())))
    for name, (_, ptxas) in built.items():
        print(f"{name}:\n  " + "\n  ".join(ptxas), flush=True)
    for name, (library, _) in built.items():
        for shape in (chip_smoke.FLASH_FLAGSHIP_SHAPE, chip_smoke.FLASH_WIDE_SHAPE):
            results = chip_smoke.with_library("flash_attention", library, lambda: chip_smoke.flash_case(
                fa, torch.float32, shape, True, 0.1, device, f"flash variant {name!r}"))
            faults = [fault for _, fault in results.values() if fault]
            if faults:
                raise AssertionError(f"{name} at {shape}: {faults}")
    order = list(built) + ["as built"]
    seed = torch.tensor([5], dtype=torch.int32, device=device)
    for depth in (16, 32, 64, 128):
        shape = chip_smoke.FLASH_TIMED[("tf32x3", depth)]
        for use_rel in (False, True):
            for rate in (0.0, 0.1):
                q, k, v, e, dout = chip_smoke.flash_inputs(torch.float32, use_rel, device, seed=4,
                                                           shape=shape)
                kw = dict(scale=True, dropout_rate=rate, dropout_seed=seed if rate else None)
                out, lse = fa.flash_attention_reference(q, k, v, e, **kw)
                runs = {"fwd": lambda: fa.flash_attention_forward(q, k, v, e, **kw),
                        "bwd": lambda: fa.flash_attention_backward(q, k, v, e, out, lse, dout,
                                                                   **kw)}
                times = []
                for name in order:
                    ms = [chip_smoke.with_library("flash_attention", built[name][0],
                                                  lambda: chip_smoke.cuda_ms(fn, 10))
                          for fn in runs.values()]
                    times.append(f"{name} {ms[0]:.4f} / {ms[1]:.4f}")
                print(f"B,H,S,D,W={shape} rel={use_rel} dropout={rate} (fwd / bwd ms): "
                      + "; ".join(times) + f" [{card}]", flush=True)
                del q, k, v, e, dout, out, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
