"""The speculative kernel's acceptance on a trained model and its speed
against the sequential kernel, on one CUDA card: what settles which engine
``generate_ids(engine="auto")`` takes for one greedy sequence.

    python3 scripts/spec_acceptance.py [--steps 1000] [--pieces 4000]

1. Corpus: ``--pieces`` synthetic tonal pieces (``make_piece``, a copy of
   ``data/scripts/make_synthetic_corpus.py``'s generator written against the
   port's ``NoteSequence``; ``random.Random(42)``), encoded by the port's
   codec in memory; the last fifth of the pieces is held out.
2. Training: the default model with ``use_pallas_attention`` (bf16, dropout
   0.1 / 0.1, relative attention off) through the port's ``Trainer``, batch
   8 x 1024, learning rate 1e-3 with 200 warm-up steps, for ``--steps``
   steps; prints the held-out loss.
3. Measurement, bf16 weights: for 4 held-out prompts (the first 10 events of
   4 held-out pieces), 1 x 1014 greedy by the speculative kernel
   (``spec_decode``) at T in {2, 3, 4, 5, 8} and by the sequential kernel
   (``decode_generate``), each timed with CUDA events; prints per T the
   acceptance (tokens per generation block), us per verify block, block /
   step (the acceptance at which spec breaks even) and kernel events/s of
   both engines with their ratio, medians over the prompts; then the wall
   time of ``generate_ids`` with ``engine="spec"`` (T=5) and
   ``engine="megakernel"`` on the same requests, in turns. Every spec run's
   ids must equal the sequential kernel's (exit 1 otherwise).

Imports neither ``composer_tpu`` nor JAX. Prints the card's name and power
limit beside every time.
"""

from __future__ import annotations

import argparse
import importlib.util
import random
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from composer_tpu_torch.midi.events import Note, NoteSequence, SustainPeriod  # noqa: E402

MAJOR = [0, 2, 4, 5, 7, 9, 11]
MINOR = [0, 2, 3, 5, 7, 8, 10]
BLOCKS = (2, 3, 4, 5, 8)
PROMPT_EVENTS, GENERATE_EVENTS, CACHE = 10, 1014, 1024
BATCH, WINDOW = 8, 1024


def make_piece(rng: random.Random) -> NoteSequence:
    """One synthetic piece: block chords on a tonic / subdominant /
    dominant walk, a diatonic melody (a random walk over scale degrees with a
    cadence pull), phrase-shaped velocities and occasional sustain; the same
    draws from ``rng`` as ``make_synthetic_corpus.py``, so the same notes."""
    scale = rng.choice([MAJOR, MINOR])
    tonic = rng.randint(48, 60)
    beat_ms = rng.choice([300, 375, 450])
    bars = rng.randint(16, 32)
    beats_per_bar = 4

    notes = []
    sustains = []
    degree = rng.randint(0, 6)

    # Chords: tonic / subdominant / dominant walk, one per bar.
    progression = [0, 3, 4, 0]
    for bar in range(bars):
        bar_start = bar * beats_per_bar * beat_ms
        root = progression[bar % len(progression)]
        chord_vel = rng.randint(35, 55)
        for interval in (0, 2, 4):  # triad in scale degrees
            deg = root + interval
            pitch = tonic - 12 + scale[deg % 7] + 12 * (deg // 7)
            notes.append(Note(bar_start, bar_start + beats_per_bar * beat_ms - 30, pitch,
                              chord_vel))
        # Sustain pedal on some bars.
        if rng.random() < 0.3:
            sustains.append(SustainPeriod(bar_start, bar_start + beats_per_bar * beat_ms))

    # Melody: random walk, cadence pull to the tonic at phrase ends.
    t = 0.0
    total_ms = bars * beats_per_bar * beat_ms
    phrase_len = 4 * beats_per_bar * beat_ms
    base_vel = rng.randint(60, 80)
    while t < total_ms:
        in_phrase = (t % phrase_len) / phrase_len
        if in_phrase > 0.85:
            degree += (0 - degree % 7) // 2  # pull toward tonic
        else:
            degree += rng.choice([-2, -1, -1, 1, 1, 2])
        degree = max(-3, min(13, degree))
        pitch = tonic + 12 + scale[degree % 7] + 12 * (degree // 7)
        pitch = max(21, min(108, pitch))
        dur = rng.choice([beat_ms // 2, beat_ms // 2, beat_ms, beat_ms * 2])
        # Phrase-shaped dynamics with jitter.
        vel = int(base_vel + 20 * (0.5 - abs(in_phrase - 0.5)) + rng.randint(-5, 5))
        notes.append(Note(t, t + dur - 20, pitch, max(20, min(110, vel))))
        t += dur

    return NoteSequence(notes=notes, sustain_periods=sustains)


def corpus(config, pieces: int, seed: int = 42):
    """(train stream, held-out pieces' id arrays): each piece encoded by the
    codec, the last fifth held out."""
    rng = random.Random(seed)
    encoded = [make_piece(rng).to_event_sequence(
        config.dataset.time_step_increment, config.dataset.max_time_steps,
        config.dataset.velocity_bins).to_ids().astype(np.int32) for _ in range(pieces)]
    split = pieces - pieces // 5
    return np.concatenate(encoded[:split]), encoded[split:]


def chip_smoke_module():
    """This checkout's ``chip_smoke.py`` (its card line and CUDA-event timer)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def train(config, stream, held_out, steps: int, device, card: str):
    """The trained model (eval mode) after ``steps`` steps; prints the
    held-out loss."""
    from composer_tpu_torch.data import WindowDataset
    from composer_tpu_torch.models import ModelType, create_model
    from composer_tpu_torch.train.trainer import Trainer

    model, _ = create_model(ModelType.TRANSFORMER, config, device=device)
    dataset = WindowDataset(stream, BATCH, WINDOW, shuffle=True, seed=0)
    trainer = Trainer(model, ModelType.TRANSFORMER, learning_rate=1e-3, seed=0,
                      warmup_steps=200, device=device)
    state = trainer.init_state(BATCH, WINDOW)
    epochs = -(-steps // len(dataset))
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        state = trainer.train(dataset, state, tmp, epochs=epochs, show_progress_bar=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    test = WindowDataset(np.concatenate(held_out), BATCH, WINDOW, shuffle=False,
                         clamp_batch=True)
    metrics = trainer.evaluate(test, state)
    print(f"trained {epochs} epochs x {len(dataset)} steps ({stream.size} train events) in "
          f"{seconds:.1f} s; held-out loss {metrics['loss']:.4f}, accuracy "
          f"{metrics['accuracy']:.4f}, perplexity {metrics['perplexity']:.3f} over "
          f"{len(test)} batches [{card}]", flush=True)
    return state.model.eval()


def measure(model, prompts, device, card: str, chip_smoke) -> bool:
    """The sweep of step 3; returns whether every spec run's ids equal the
    sequential kernel's."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_spec as dks
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.train import generate as gen

    engine = gen._packed_engine(model, None)
    packed, config = engine.packed, engine.config
    steps = PROMPT_EVENTS + GENERATE_EVENTS - 1
    temps, topk, topp = dk.row_params(1, packed["wte"].shape[0], 0.0, 0, 0.0, True, False,
                                      False, device)
    plens = torch.full((1,), PROMPT_EVENTS, dtype=torch.int32, device=device)
    rows, equal = {T: [] for T in BLOCKS}, True
    seq_ms = []
    for prompt in prompts:
        row = torch.as_tensor(prompt, dtype=torch.int32, device=device)
        sequential = decode_generate(packed, row[None], plens, 0, temps, topk, topp, None, None,
                                     config=config, num_steps=steps, out_len=GENERATE_EVENTS,
                                     cache_len=CACHE, start_step=0)
        ms = chip_smoke.cuda_ms(lambda: decode_generate(
            packed, row[None], plens, 0, temps, topk, topp, None, None, config=config,
            num_steps=steps, out_len=GENERATE_EVENTS, cache_len=CACHE, start_step=0), 2)
        seq_ms.append(ms)
        for T in BLOCKS:
            kwargs = dict(config=config, length=GENERATE_EVENTS, cache_len=CACHE, block=T)
            args = (packed, row, 0, 0.0, float(packed["wte"].shape[0] + 1), 2.0)
            tokens, stats = dks.spec_decode(*args, **kwargs)
            spec = chip_smoke.cuda_ms(lambda: dks.spec_decode(*args, **kwargs), 2)
            same = torch.equal(tokens, sequential[0])
            equal &= same
            blocks, gen_blocks = int(stats[0]), int(stats[1])
            rows[T].append((GENERATE_EVENTS / gen_blocks, spec / blocks * 1e3,
                            (spec / blocks) / (ms / steps), GENERATE_EVENTS / spec * 1e3,
                            ms / spec, same))
    median_seq = float(np.median(seq_ms))
    print(f"sequential kernel (decode_generate, G {decode_generate.cluster}): median "
          f"{median_seq:.3f} ms, {median_seq / steps * 1e3:.2f} us a step, "
          f"{GENERATE_EVENTS / median_seq * 1e3:.1f} events/s [{card}]", flush=True)
    for T in BLOCKS:
        acc, us, ratio, events, speed, same = (np.median([r[i] for r in rows[T]])
                                               for i in range(6))
        per_prompt = ", ".join(f"{r[0]:.3f}" for r in rows[T])
        print(f"spec T={T} (G {dks.spec_decode.cluster}): acceptance {acc:.3f} tokens per "
              f"generation block (per prompt {per_prompt}); {us:.1f} us per block, block / "
              f"step {ratio:.3f} (break-even acceptance); {events:.1f} events/s, "
              f"{speed:.3f}x the sequential kernel; ids equal to the sequential kernel's in "
              f"{int(sum(r[5] for r in rows[T]))} of {len(rows[T])} [{card}]", flush=True)

    # The route itself: generate_ids' wall time, spec at its default block
    # (SPEC_BLOCK_GREEDY) against the sequential kernel, in turns.
    walls = {"spec": [], "megakernel": []}
    for prompt in prompts:
        outputs = []
        for name in ("megakernel", "spec", "spec", "megakernel"):
            torch.cuda.synchronize()
            start = time.perf_counter()
            outputs.append(gen.generate_ids(model, ModelType.TRANSFORMER, None, prompt,
                                            length=GENERATE_EVENTS, temperature=0.0,
                                            engine=name))
            walls[name].append(time.perf_counter() - start)
        equal &= all(np.array_equal(outputs[0], ids) for ids in outputs[1:])
    spec_wall, seq_wall = (float(np.median(walls[name])) for name in ("spec", "megakernel"))
    print(f"generate_ids 1 x {GENERATE_EVENTS} greedy, host clock, medians over "
          f"{len(prompts)} prompts x 2: engine='spec' (T={dks.default_block(True)}) "
          f"{spec_wall:.4f} s ({GENERATE_EVENTS / spec_wall:.1f} events/s), "
          f"engine='megakernel' {seq_wall:.4f} s ({GENERATE_EVENTS / seq_wall:.1f} events/s); "
          f"spec / sequential events/s {seq_wall / spec_wall:.3f} [{card}]", flush=True)
    return equal


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--pieces", type=int, default=4000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("spec_acceptance.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    from composer_tpu_torch.config import get_default

    chip_smoke = chip_smoke_module()
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    config = get_default()
    config.transformer.model.use_pallas_attention = True
    start = time.perf_counter()
    stream, held_out = corpus(config, args.pieces)
    print(f"corpus: {args.pieces} pieces, {stream.size} train events, "
          f"{sum(p.size for p in held_out)} held out, built in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    model = train(config, stream, held_out, args.steps, device, card)
    prompts = [piece[:PROMPT_EVENTS] for piece in held_out[:4]]
    equal = measure(model, prompts, device, card, chip_smoke)
    print(f"every spec run's ids equal the sequential kernel's: {equal}", flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
