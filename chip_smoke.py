"""Smoke run of the PyTorch port on one CUDA card: builds the decode kernel,
holds it against its plain PyTorch version, then drives the serving path.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. The card's name and power limit, and the kernel's build time.
2. The hand-written kernel ``decode_generate`` (csrc/decode_generate.cu)
   against its plain PyTorch version on the card, on random weights made
   from a numpy seed at the default model's widths. float32: greedy and
   sampled ids must be identical (both sides draw the same Philox noise) for
   batch 8 with relative attention off and on, batch 1, ragged prompts and a
   prefill import, at 64 steps with cache 128, and again at the main path's
   shapes (batch 8 x (10 + 1014) and batch 1, cache 1024); the last step's
   logits must agree within 1e-3. bfloat16: logits of a teacher-forced run
   must agree within 2% of their scale, and the sampled-id agreement rate is
   printed.
3. The port's main path, ``generate_ids(engine="auto")`` on the default
   config with bfloat16 packed weights: batch 8 x (10 + 1014) events from a
   prompt encoded by the MIDI codec, batch 1 x 1024, a 100-event prompt that
   takes the parallel prefill, and batch 8 with relative attention on. The
   kernel's launch counters must rise, ids must lie in the vocabulary, and
   a MIDI file is written. The device's busy share of a call is measured
   with CUDA events around the call and around the kernel's launch. Then
   kernel and plain version are timed at the same shapes; their ids are
   compared, and the plain version's output, teacher-forced through both,
   must give last-step logits within the bfloat16 rule.

Prints a JSON line describing each kernel, then, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

F32_LOGIT_TOL = 1e-3  # f32, different summation orders
BF16_LOGIT_REL_TOL = 0.02  # bf16 roundings of intermediate activations
PROMPT_EVENTS = 10
GENERATE_EVENTS = 1014


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def random_flax_params(config, seed: int) -> dict:
    """A Flax-layout parameter tree from a numpy seed, scaled so that greedy
    decoding through 8 layers stays varied (fan-in scaled matmuls, MLP
    output x4, attention x0.5, LayerNorm scale and bias off identity)."""
    rng = np.random.default_rng(seed)
    E, H, D = config.embed_dim, config.num_heads, config.head_dim

    def normal(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def norm():
        return {"scale": 1 + normal(E, std=0.1), "bias": normal(E, std=0.1)}

    def dense(n_in, n_out, gain):
        return {"kernel": normal(n_in, n_out, std=gain / np.sqrt(n_in)),
                "bias": normal(n_out, std=0.02)}

    params = {"wte": normal(config.vocab_size, E, std=1.0),
              "wpe": normal(config.window_size, E, std=1.0), "ln_f": norm()}
    for layer in range(config.num_layers):
        attn = {"c_attn": dense(E, 3 * E, 0.5), "c_proj": dense(E, E, 0.5)}
        if config.use_relative_attention:
            attn["rel_embedding"] = normal(H, config.window_size, D, std=1 / np.sqrt(D))
        params[f"h_{layer + 1}"] = {"ln_1": norm(), "ln_2": norm(), "attn": attn,
                                    "mlp": {"c_fc": dense(E, 4 * E, 1.0),
                                            "c_proj": dense(4 * E, E, 4.0)}}
    return params


def build_model(use_relative: bool, device):
    from composer_tpu.config import get_default
    from composer_tpu.models import ModelType
    from composer_tpu_torch.models import create_model
    from composer_tpu_torch.models.convert import params_from_flax

    config = get_default()
    config.transformer.model.use_relative_attention = use_relative
    model, _ = create_model(ModelType.TRANSFORMER, config, device=device)
    state = params_from_flax(random_flax_params(model.config, seed=0), model.config)
    model.load_state_dict({k: v.to(device) for k, v in state.items()})
    return model.eval(), config


def run_both(packed, config, prompts, plens, temps, topk, topp, *, length, cache_len,
             rows=(None, None), start_step=0, seed=0):
    """(kernel ids, plain ids, max |logits difference| at the last step)."""
    from composer_tpu_torch.ops.decode_kernel_batched import (
        decode_generate,
        decode_generate_reference,
    )

    device = packed["wte"].device
    width = prompts.shape[1]
    kwargs = dict(config=config, num_steps=width + length - 1,
                  out_len=width + length - 1, cache_len=cache_len, start_step=start_step)
    args = (packed, prompts, plens, seed, temps, topk, topp, *rows)
    logits = [torch.zeros((prompts.shape[0], packed["wte"].shape[0]), device=device)
              for _ in range(2)]
    ours = decode_generate(*args, **kwargs, logits_out=logits[0])
    plain = decode_generate_reference(*args, **kwargs, logits_out=logits[1])
    torch.cuda.synchronize()
    return ours.cpu(), plain.cpu(), float((logits[0] - logits[1]).abs().max()), logits[1]


def kernel_vs_plain(device) -> dict:
    """Phase 2; returns the f32 logits errors per form."""
    from composer_tpu_torch.models.transformer import init_cache
    from composer_tpu_torch.ops import decode_kernel as dk

    rng = np.random.default_rng(1)
    errors = {"batched": 0.0, "single": 0.0}

    def vectors(batch, temps, topk, topp):
        return dk.row_params(batch, 512, temps, topk, topp, False, True, True, device)

    greedy8 = vectors(8, 0.0, 0, 0.0)
    sampled8 = vectors(8, np.array([1.0, 0.8, 0.0, 1.2, 1.0, 0.7, 1.0, 1.0], np.float32),
                       np.array([0, 20, 0, 5, 0, 40, 0, 3]),
                       np.array([0.9, 0.0, 0.0, 0.8, 0.0, 0.95, 0.0, 0.0], np.float32))
    for use_relative in (False, True):
        model, _ = build_model(use_relative, device)
        config = model.config
        packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32,
                                 device=device)
        prompts = torch.as_tensor(rng.integers(0, 390, (8, 9)), dtype=torch.int32,
                                  device=device)
        full = torch.full((8,), 9, dtype=torch.int32, device=device)
        ragged = torch.tensor([9, 3, 7, 1, 9, 5, 8, 2], dtype=torch.int32, device=device)
        cache = init_cache(config, 8, 5, device=device)
        with torch.no_grad():
            _, cache = model(prompts[:, :5].long(), cache)
        rows = dk.cache_to_rows_batched(cache, config, 128, dtype=torch.float32)
        cases = [
            ("B=8 greedy", prompts, full, greedy8, {}),
            ("B=8 sampled", prompts, full, sampled8, {"seed": 5}),
            ("B=8 ragged", prompts, ragged, greedy8, {}),
            ("B=8 ragged sampled", prompts, ragged, sampled8, {"seed": 6}),
            ("B=8 prefill import", prompts, full, greedy8, {"rows": rows, "start_step": 5}),
            ("B=8 prefill import sampled", prompts, full, sampled8,
             {"rows": rows, "start_step": 5, "seed": 7}),
            ("B=1 greedy", prompts[:1], full[:1], vectors(1, 0.0, 0, 0.0), {}),
            ("B=1 sampled", prompts[:1], full[:1], vectors(1, 1.0, 30, 0.9), {"seed": 8}),
        ]
        # The main path's shapes: 10 prompt + 1014 generated, cache 1024.
        main = torch.as_tensor(np.random.default_rng(2).integers(0, 390, (8, PROMPT_EVENTS)),
                               dtype=torch.int32, device=device)
        main_plens = torch.full((8,), PROMPT_EVENTS, dtype=torch.int32, device=device)
        cases = [(*case, 64, 128) for case in cases] + [
            (f"{name} main shape", p, plens, vectors_, extra, GENERATE_EVENTS, 1024)
            for name, p, plens, vectors_, extra in (
                ("B=8 greedy", main, main_plens, greedy8, {}),
                ("B=8 sampled", main, main_plens, sampled8, {"seed": 10}),
                ("B=1 greedy", main[:1], main_plens[:1], vectors(1, 0.0, 0, 0.0), {}),
                ("B=1 sampled", main[:1], main_plens[:1], vectors(1, 1.0, 30, 0.9),
                 {"seed": 11}),
            )]
        for name, p, plens, (temps, topk, topp), extra, length, cache_len in cases:
            ours, plain, err, _ = run_both(packed, config, p, plens, temps, topk, topp,
                                           length=length, cache_len=cache_len, **extra)
            distinct = len(set(plain.flatten().tolist()))
            print(f"f32 rel={use_relative} {name}: ids identical={torch.equal(ours, plain)} "
                  f"logits max_abs_err={err:.3e} distinct ids={distinct}", flush=True)
            if not torch.equal(ours, plain):
                raise AssertionError(f"kernel and plain version disagree: {name}")
            if err > F32_LOGIT_TOL:
                raise AssertionError(f"f32 logits differ by {err} > {F32_LOGIT_TOL}: {name}")
            if "greedy" in name and distinct < 8:
                raise AssertionError(f"degenerate greedy output ({distinct} ids): {name}")
            form = "single" if p.shape[0] == 1 else "batched"
            errors[form] = max(errors[form], err)

    # bf16: teacher-forced logits (no feedback, so no divergence), then ids.
    model, _ = build_model(False, device)
    packed = dk.pack_weights(model.state_dict(), model.config, dtype=torch.bfloat16,
                             device=device)
    prompts = torch.as_tensor(rng.integers(0, 390, (8, 64)), dtype=torch.int32, device=device)
    full = torch.full((8,), 64, dtype=torch.int32, device=device)
    _, _, err, logits = run_both(packed, model.config, prompts, full, *greedy8, length=1,
                                 cache_len=128)
    scale = float(logits[:, :390].abs().max())
    ours, plain, _, _ = run_both(packed, model.config, prompts[:, :10].contiguous(),
                                 full.clamp(max=10),
                                 *sampled8, length=256, cache_len=384, seed=9)
    agree = float((ours == plain).float().mean())
    print(f"bf16 teacher-forced logits max_abs_err={err:.3e} (scale {scale:.3f}); "
          f"sampled ids agreement={agree:.4f}", flush=True)
    if err > BF16_LOGIT_REL_TOL * scale:
        raise AssertionError(f"bf16 logits differ by {err} > {BF16_LOGIT_REL_TOL} x {scale}")
    return errors


def encoded_prompt(config, events: int) -> np.ndarray:
    """A prompt encoded by the MIDI codec from a small NoteSequence."""
    from composer_tpu.midi.events import Note, NoteSequence

    notes = [Note(0.25 * i, 0.25 * i + 0.5, 60 + (i * 5) % 12, 64 + (i % 4) * 8)
             for i in range(events)]
    sequence = NoteSequence(notes).to_event_sequence(
        config.dataset.time_step_increment, config.dataset.max_time_steps,
        config.dataset.velocity_bins,
    )
    ids = sequence.to_ids().astype(np.int32)
    if ids.size < events:
        raise AssertionError(f"codec gave {ids.size} events, wanted {events}")
    return ids[:events]


def write_midi(ids, config, path: Path) -> int:
    from composer_tpu.midi.events import EventSequence

    EventSequence.from_ids(
        ids, config.dataset.time_step_increment, config.dataset.max_time_steps,
        config.dataset.velocity_bins,
    ).to_note_sequence().to_midi(str(path))
    return path.stat().st_size


class KernelSpans:
    """Stands in for the kernel's loaded library and records CUDA events
    around each call of its C entry point. The call only enqueues the
    kernel, so on the stream the two events bracket the kernel itself."""

    def __init__(self, lib):
        self.lib = lib
        self.spans = []

    def decode_generate(self, *args):
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        begin.record()
        err = self.lib.decode_generate(*args)
        end.record()
        self.spans.append((begin, end))
        return err


def main_path(device, card: str) -> dict:
    """Phase 3: the serving path through its user entry point."""
    from composer_tpu.models import ModelType
    from composer_tpu_torch.ops import _build
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.train import generate as gen

    model, config = build_model(False, device)
    rel_model, _ = build_model(True, device)
    prompt = encoded_prompt(config, PROMPT_EVENTS)
    batch8 = np.tile(prompt, (8, 1))
    long_prompt = np.tile(encoded_prompt(config, 50), 2)  # 100 events
    kernel_spans = KernelSpans(_build.load_library("decode_generate"))
    load_library = _build.load_library
    _build.load_library = lambda name="decode_generate": kernel_spans

    def generate(m, prompts, length, **kwargs):
        """(ids, host wall s, device window ms, kernel ms) of one call; the
        window is CUDA events recorded just before and just after it."""
        window = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        kernel_spans.spans.clear()
        torch.cuda.synchronize()
        start = time.perf_counter()
        window[0].record()
        ids = gen.generate_ids(m, ModelType.TRANSFORMER, None, prompts, length=length,
                               temperature=1.0, engine="auto", **kwargs)
        window[1].record()
        wall = time.perf_counter() - start
        torch.cuda.synchronize()
        kernel_ms = sum(b.elapsed_time(e) for b, e in kernel_spans.spans)
        return ids, wall, window[0].elapsed_time(window[1]), kernel_ms

    prefills = []
    decode_generate.launches_batched = 0
    decode_generate.launches_single = 0
    ids8, *_ = generate(model, batch8, GENERATE_EVENTS, seed=1)  # packs the weights
    ids8, wall8, window8, kernel8 = generate(model, batch8, GENERATE_EVENTS, seed=2)
    ids1, wall1, window1, kernel1 = generate(model, prompt, GENERATE_EVENTS, seed=3)
    engine = gen._packed_engine(model, None)
    original = engine._prefill_rows
    engine._prefill_rows = lambda *a: prefills.append(a[0].shape) or original(*a)
    ids_long, *_ = generate(model, np.tile(long_prompt, (8, 1)), 256, seed=4)
    ids_rel, *_ = generate(rel_model, batch8, GENERATE_EVENTS, seed=5)
    launches = {"batched": decode_generate.launches_batched,
                "single": decode_generate.launches_single}
    _build.load_library = load_library

    print(f"main path launches {launches}, prefill calls {prefills}", flush=True)
    if launches["batched"] < 4 or launches["single"] < 1:
        raise AssertionError(f"the main path did not run through the kernel: {launches}")
    if not prefills or prefills[0][1] != 64:
        raise AssertionError(f"the 100-event prompt skipped the parallel prefill: {prefills}")
    for name, ids, width, length in (("B=8", ids8, PROMPT_EVENTS, GENERATE_EVENTS),
                                     ("B=1", ids1[None], PROMPT_EVENTS, GENERATE_EVENTS),
                                     ("prefill", ids_long, 100, 256),
                                     ("rel", ids_rel, PROMPT_EVENTS, GENERATE_EVENTS)):
        if ids.shape[1] != width + length or ids.min() < 0 or ids.max() >= 390:
            raise AssertionError(f"{name}: bad ids, shape {ids.shape}, "
                                 f"range [{ids.min()}, {ids.max()}]")
        print(f"{name}: {ids.shape[0]} x {ids.shape[1]} ids, "
              f"{len(set(ids[:, width:].ravel().tolist()))} distinct generated", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        size = write_midi(ids8[0], config, Path(tmp) / "sample.mid")
    if size <= 0:
        raise AssertionError("the MIDI file is empty")
    events8 = 8 * GENERATE_EVENTS
    print(f"MIDI written: {size} bytes", flush=True)
    print(f"generate_ids wall, kernel: B=8 x {GENERATE_EVENTS}: {events8 / wall8:.1f} events/s "
          f"({wall8:.3f} s); B=1 x {GENERATE_EVENTS}: {GENERATE_EVENTS / wall1:.1f} events/s "
          f"({wall1:.3f} s) [{card}]", flush=True)
    for name, window, kernel in (("B=8", window8, kernel8), ("B=1", window1, kernel1)):
        print(f"{name} generate_ids call: device window {window:.3f} ms (CUDA events), "
              f"kernel {kernel:.3f} ms, busy share {kernel / window:.5f} [{card}]",
              flush=True)
    return {"launches": launches, "engine": engine, "prompt": prompt}


def timings(device, engine, prompt, card: str) -> dict:
    """Kernel (CUDA events) and plain version (host clock after a
    synchronize) at the main path's shapes, bf16 weights, temperature 1.
    Their sampled ids are compared; then the plain version's sequences are
    teacher-forced through both (no feedback, so bf16 roundings cannot
    compound) and the last step's logits, over the full 1024-slot cache,
    must agree within the bf16 rule."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops.decode_kernel_batched import (
        decode_generate,
        decode_generate_reference,
    )

    result = {}
    for form, batch in (("batched", 8), ("single", 1)):
        prompts = torch.as_tensor(np.tile(prompt, (batch, 1)), dtype=torch.int32,
                                  device=device)
        plens = torch.full((batch,), PROMPT_EVENTS, dtype=torch.int32, device=device)
        temps, topk, topp = dk.row_params(batch, 512, 1.0, 0, 0.0, False, False, False,
                                          device)
        num_steps = PROMPT_EVENTS + GENERATE_EVENTS - 1
        args = (engine.packed, prompts, plens, 0, temps, topk, topp, None, None)
        kwargs = dict(config=engine.config, num_steps=num_steps, out_len=GENERATE_EVENTS,
                      cache_len=1024, start_step=0)
        ours = decode_generate(*args, **kwargs)  # warm-up
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        repeats = 3
        begin.record()
        for _ in range(repeats):
            decode_generate(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        kernel_ms = begin.elapsed_time(end) / repeats
        start = time.perf_counter()
        plain = decode_generate_reference(*args, **kwargs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - start) * 1e3
        events = batch * GENERATE_EVENTS
        print(f"B={batch} x {GENERATE_EVENTS} bf16: kernel {kernel_ms:.2f} ms "
              f"({events / kernel_ms * 1e3:.1f} events/s), plain {plain_ms:.2f} ms "
              f"({events / plain_ms * 1e3:.1f} events/s) [{card}]", flush=True)
        agree = float((ours == plain).float().mean())
        forced = torch.cat([prompts, plain], dim=1)[:, :num_steps].contiguous()
        widths = torch.full((batch,), num_steps, dtype=torch.int32, device=device)
        _, _, err, logits = run_both(engine.packed, engine.config, forced, widths, temps,
                                     topk, topp, length=1, cache_len=1024)
        scale = float(logits[:, :engine.config.vocab_size].abs().max())
        print(f"B={batch} bf16 main shape: sampled ids agreement={agree:.4f}; teacher-forced "
              f"last-step logits max_abs_err={err:.3e} (scale {scale:.3f})", flush=True)
        if err > BF16_LOGIT_REL_TOL * scale:
            raise AssertionError(f"bf16 logits differ by {err} > {BF16_LOGIT_REL_TOL} x {scale}")
        result[form] = (kernel_ms, plain_ms)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    from composer_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    start = time.perf_counter()
    _build.build("decode_generate")
    _build.load_library("decode_generate")
    print(f"kernel build: {time.perf_counter() - start:.1f} s", flush=True)
    print(_build.BUILD_INFO["decode_generate"]["log"].strip(), flush=True)

    errors = kernel_vs_plain(device)
    path = main_path(device, card)
    times = timings(device, path["engine"], path["prompt"], card)

    source = "composer_tpu_torch/csrc/decode_generate.cu"
    kernels = [
        {"name": "decode_generate (B>1)", "route": "cuda", "source": source,
         "replaces": "composer_tpu/ops/decode_kernel_batched.py:100",
         "launches": path["launches"]["batched"], "max_abs_err": errors["batched"],
         "ms": times["batched"][0], "plain_ms": times["batched"][1]},
        {"name": "decode_generate (B=1)", "route": "cuda", "source": source,
         "replaces": "composer_tpu/ops/decode_kernel.py:203",
         "launches": path["launches"]["single"], "max_abs_err": errors["single"],
         "ms": times["single"][0], "plain_ms": times["single"][1]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
