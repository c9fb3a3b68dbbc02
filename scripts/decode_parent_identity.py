"""Holds ``decode_generate`` against another checkout's, on one CUDA card:
ids and last-step logits bit for bit (the check that a redesign of the
kernel changed its schedule and not its arithmetic), and its times beside
the other's.

    python3 scripts/decode_parent_identity.py <other checkout>

Runs each checkout's ``composer_tpu_torch`` in a process of its own, in the
order other, this, this, other; every process uses this checkout's
``chip_smoke.py`` (``build_model``, ``steps_from_ms``) on the package of the
checkout it runs, which builds its kernels under its own ``build/``. The
results go to this checkout's ``build/parent_identity/``. The cases are the
default model's widths (random weights from a seed), 10 prompt + 1014
events at cache 1024, float32 and bfloat16 weights, batch 8, 1, 48 and 80
(clusters of 8, 16, 2 and 1 on an H100), greedy and sampled (temperature
0.8, top-k 40, top-p 0.95), relative attention off and on; the times, in
bf16 at the same batches, are 64 steps from positions 0 and 960 and a whole
greedy generation. Prints one line per case and per run and exits 1 unless
every case is equal.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
BATCHES = (8, 1, 48, 80)


def chip_smoke_module():
    """This checkout's ``chip_smoke.py``, whatever package is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_checkout(root: Path, out: Path) -> None:
    """Generates every case and times every batch with ``root``'s package."""
    sys.path.insert(0, str(root))
    from types import SimpleNamespace

    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate

    if not Path(dk.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {dk.__file__}, not {root}'s package")
    chip_smoke = chip_smoke_module()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs, times, clusters = {}, {}, {}
    for relative in (False, True):
        model, _ = chip_smoke.build_model(relative, device)
        for dtype in (torch.float32, torch.bfloat16):
            packed = dk.pack_weights(model.state_dict(), model.config, dtype=dtype, device=device)
            for batch in BATCHES:
                prompts = torch.as_tensor(np.random.default_rng(2).integers(0, 390, (batch, 10)),
                                          dtype=torch.int32, device=device)
                plens = torch.full((batch,), 10, dtype=torch.int32, device=device)
                for name, sampling in (("greedy", (0.0, 0, 0.0)), ("sampled", (0.8, 40, 0.95))):
                    rows = dk.row_params(batch, 512, *sampling, False, True, True, device)
                    logits = torch.zeros((batch, 512), device=device)
                    ids = decode_generate(packed, prompts, plens, 10, *rows, None, None,
                                          config=model.config, num_steps=1023, out_len=1023,
                                          cache_len=1024, start_step=0, logits_out=logits)
                    runs[(relative, str(dtype), batch, name)] = (ids.cpu(), logits.cpu())
            if dtype == torch.bfloat16 and not relative:
                engine = SimpleNamespace(config=model.config, packed=packed)
                for batch in BATCHES:
                    for start in (0, 960):
                        ms = chip_smoke.steps_from_ms(engine, batch, start, device)
                        times[(batch, f"64 steps from {start}")] = ms
                    prompts = torch.as_tensor(
                        np.random.default_rng(2).integers(0, 390, (batch, 10)),
                        dtype=torch.int32, device=device)
                    plens = torch.full((batch,), 10, dtype=torch.int32, device=device)
                    rows = dk.row_params(batch, 512, 0.0, 0, 0.0, False, True, True, device)
                    times[(batch, "10 + 1014")] = chip_smoke.cuda_ms(
                        lambda: decode_generate(packed, prompts, plens, 10, *rows, None, None,
                                                config=model.config, num_steps=1023,
                                                out_len=1023, cache_len=1024, start_step=0), 3)
                    clusters[batch] = getattr(decode_generate, "cluster", None)
    torch.save({"runs": runs, "times": times, "clusters": clusters,
                "card": chip_smoke.card_line()}, out)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        run_checkout(Path(sys.argv[2]), Path(sys.argv[3]))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve()
    out_dir = ROOT / "build" / "parent_identity"
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for turn, (name, root) in enumerate((("other", other), ("this", ROOT), ("this", ROOT),
                                         ("other", other))):
        out = out_dir / f"{turn}.pt"
        subprocess.run([sys.executable, __file__, "--run", str(root), str(out)], check=True)
        result = torch.load(out)
        results.append(result)
        print(f"{name} checkout, turn {turn}: " + ", ".join(
            f"B={batch} (G {result['clusters'][batch]}) {what} {ms:.3f} ms"
            for (batch, what), ms in result["times"].items()) + f" [{result['card']}]",
            flush=True)
    theirs, ours = results[0]["runs"], results[1]["runs"]
    equal = 0
    for key, (ids, logits) in ours.items():
        same = torch.equal(ids, theirs[key][0]) and torch.equal(logits, theirs[key][1])
        equal += same
        print(f"relative={key[0]} {key[1]} B={key[2]} {key[3]}: ids and logits equal={same}",
              flush=True)
    print(f"{equal} of {len(ours)} cases equal [{results[1]['card']}]")
    return 0 if equal == len(ours) else 1


if __name__ == "__main__":
    sys.exit(main())
