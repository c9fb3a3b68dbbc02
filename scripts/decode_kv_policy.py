"""Times ``decode_generate`` with its K/V loads marked evict-first (the
kernel as built: ``kv_dot`` and ``cluster_gemv<T, true>`` in
``csrc/decode_cluster.cuh``) against a copy that loads the K/V rows with the
default cache policy, on one CUDA card.

    python3 scripts/decode_kv_policy.py

Both run the default model's widths in bf16 (random weights from a seed),
64 steps from position 0 and from position 960 at batch 8 and batch 1
(``chip_smoke.steps_from_ms``), in turns: as built, default, default, as
built. The copy is built under ``build/kv_policy/``. Prints one line per
turn with the card's name and power limit.

The copy is made by replacing the two K/V load lines of
``decode_cluster.cuh`` by their exact text (``LOADS``) and pointing the
private ``_build.CSRC`` at it for one build: any edit to those two lines
stops the script with an ``AssertionError`` until ``LOADS`` follows it.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from composer_tpu_torch.ops import _build  # noqa: E402
from composer_tpu_torch.ops import decode_kernel as dk  # noqa: E402

# (evict-first, default) forms of the two K/V loads.
LOADS = (("__ldcs(reinterpret_cast<const uint4*>(row + d))",
          "*reinterpret_cast<const uint4*>(row + d)"),
         ("r[k] = kv ? __ldcs(p) : *p;", "r[k] = *p;"))


def default_policy_library():
    """``decode_generate`` built from a copy of the sources whose K/V loads
    use the default policy."""
    csrc = ROOT / "build" / "kv_policy" / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    header = csrc / "decode_cluster.cuh"
    text = header.read_text()
    for evict_first, default in LOADS:
        if text.count(evict_first) != 1:
            raise AssertionError(f"the K/V load {evict_first!r} no longer reads as expected")
        text = text.replace(evict_first, default)
    header.write_text(text)
    built = _build.CSRC
    _build.CSRC = csrc
    try:
        _build._LIBRARIES.pop("decode_generate", None)
        return _build.load_library("decode_generate")
    finally:
        _build.CSRC = built


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    libraries = {"default": default_policy_library()}
    _build._LIBRARIES.pop("decode_generate", None)
    libraries["evict-first"] = _build.load_library("decode_generate")
    model, _ = chip_smoke.build_model(False, device)
    engine = SimpleNamespace(config=model.config, packed=dk.pack_weights(
        model.state_dict(), model.config, dtype=torch.bfloat16, device=device))
    for name in ("evict-first", "default", "default", "evict-first"):
        _build._LIBRARIES["decode_generate"] = libraries[name]
        times = {(batch, start): chip_smoke.steps_from_ms(engine, batch, start, device)
                 for batch in (8, 1) for start in (0, 960)}
        print(f"K/V loads {name}: " + ", ".join(
            f"B={batch} 64 steps from {start} {ms:.3f} ms" for (batch, start), ms in times.items())
            + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
