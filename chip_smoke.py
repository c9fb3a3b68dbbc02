"""Smoke run of the PyTorch port on one CUDA card: builds the kernels, holds
each against its plain PyTorch version, then drives the serving path, the
training path, the HTTP layer, the CLI and MusicRNN.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. The card's name and power limit, and the kernels' build time (one nvcc
   process per source, started together).
2. The hand-written kernel ``decode_generate`` (csrc/decode_generate.cu)
   against its plain PyTorch version on the card, on random weights made
   from a numpy seed at the default model's widths. float32: greedy and
   sampled ids must be identical (both sides draw the same Philox noise) for
   batch 8 with relative attention off and on, batch 1, ragged prompts and a
   prefill import, and batch 32 (a smaller cluster per sequence), at 64
   steps with cache 128, and again at the main path's shapes (batch 8 x
   (10 + 1014) greedy and sampled and batch 1 greedy, cache 1024; with
   relative attention on, batch 8 sampled: the plain version takes 8-10 s a
   case there), where the kernel runs twice and
   must give the same ids both times (a race between the blocks of a
   cluster shows as ids that differ only sometimes); the last step's
   logits must agree within 1e-3. bfloat16: logits of a teacher-forced run
   must agree within 2% of their scale, and the sampled-id agreement rate is
   printed.
3. The port's main path, ``generate_ids(engine="auto")`` on the default
   config with bfloat16 packed weights: batch 8 x (10 + 1014) events from a
   prompt encoded by the MIDI codec, batch 1 x 1024, a 100-event prompt that
   takes the parallel prefill, and batch 8 with relative attention on. The
   kernel's launch counters must rise, ids must lie in the vocabulary, and
   a MIDI file is written; the cluster size the kernel took at B=8 and B=1
   (``cluster_size``) is printed. The device's busy share of a call is
   measured with CUDA events around the call and around the kernel's
   launch. Then kernel and plain version are timed at the same shapes;
   their ids are compared, and at batch 8 the plain version's output,
   teacher-forced through both, must give last-step logits within the
   bfloat16 rule. The
   kernel is also timed over 64 steps from position 0 and 64 from 960
   (``steps_from_ms``): the weights' share of a step against attention's.

4. The flash attention kernels (csrc/flash_attention.cu) against their
   plain PyTorch version, relative attention off and on, dropout 0 and 0.1
   with the same seed (both draw the same Philox bits), on each route of
   ``kernel_variant`` at every head_dim built (16, 32, 64, 128), each at
   the shapes the main path gives it (``FLASH_CHECKS``): float32 (the
   split-TF32 kernels of csrc/flash_attention_tf32.cuh, route ``tf32x3``:
   each product as three TF32 products) at the training path's shapes (B=8, H=16, S=1024,
   W=1024) at D=16 and 32 and padded 24, at the flagship's (B=8, S=2048,
   D=64, W=2048) and the embed-2048 architecture's (B=4, S=2048, D=128, W=2048), with
   TF32 off, O and lse within 2e-4, dq/dk/dv/dE within 5e-4 of their scale
   (float32 atomics change the summation order); bfloat16 (the tensor-core
   kernels of csrc/flash_attention_mma.cuh) at the same shapes and at D=48,
   which the wrapper pads to the D=64 kernels, lse within 1e-3 and O,
   dq/dk/dv/dE within 2% of their scale and, row by row, within 2% of each
   row's own norm (floored at a tenth of the tensor's RMS row norm), so
   that an error confined to far tiles, where typical values are small,
   still shows. ``python3 chip_smoke.py --flash-planted-faults`` shows these
   rules failing on faults planted in far tiles of copies of the kernels (a
   band row shifted by one, two dropout words swapped), bf16 at D=16, 64
   and 128 and float32 at D=64 and 128.
5. The training path, ``Trainer.train`` on a ``WindowDataset`` of event ids
   encoded by the MIDI codec: the default config with
   ``use_pallas_attention`` (bf16 compute, dropout 0.1), batch 8 x 1024,
   learning rate 1e-3, 20 steps, relative attention off and on. Forward
   and backward launches of the bf16 tensor-core kernels must each equal 8
   layers x 20 steps, the loss must be finite and fall, and the checkpoint
   must restore in a fresh ``Trainer`` whose model then generates 8 x 64
   events through ``generate_ids(engine="auto")``. Step time, train
   events/s and ``profile_steps``' flash and idle shares are printed. Then
   3 float32 steps (mixed precision off, relative attention on) through the
   split-TF32 kernels: 8 x 3 launches each way, finite losses.
5b. The flagship's training path: ``Trainer.train`` on the embed-1024
   flagship (8 layers x 16 heads of 64, window 2048, relative attention)
   with its flash recipe (``use_pallas_attention``, bf16 compute, dropout
   0.1 / 0.1), batch 8 x 2048, lr 1e-3, 5 steps on codec-encoded event ids:
   the tensor-core kernels at head_dim 64 must launch 8 x 5 times each way
   and the losses be finite; step time, train events/s and the profile's
   shares are printed. Then the flash kernels, their plain version and, as
   a yardstick the port never calls, ``scaled_dot_product_attention``
   (pinned with ``sdpa_kernel`` to the backend it takes unpinned, whose name
   is printed) are timed with CUDA events for each (route, head_dim) built
   at its shape of phase 4 (``FLASH_TIMED``), each beside ``flash_bound``;
   with ``--parent``, the parent's float32 kernels too, before and after.
5c. The embed-2048 architecture (``EMBED2048``: vocab 390, 8 layers x 16
   heads of 128, window 2048, relative attention; about 441 M parameters)
   through ``Trainer.train`` with ``use_pallas_attention``, bf16 compute,
   dropout 0, batch 4 x 2048, lr 1e-3, 5 steps on codec-encoded event ids:
   the tensor-core kernels at head_dim 128 must launch 8 x 5 times each way
   and the losses be finite; step time, train events/s, peak device memory
   and the profile's shares are printed. One more step at dropout 0.1 /
   0.1 on the trained weights (8 launches each way, counted apart). Then
   ``generate_ids(engine="auto")`` of the trained model at B=8 x (10 +
   246): it must take the wide kernel, in sub-batches of what its shared
   memory admits (``_wide_batch_cap``: 5), and ``decode_generate`` never.
   The wide kernel against its plain version in float32 at these widths,
   cut to 2 layers: 4 ragged rows x 150 steps at cache 256, greedy and
   sampled, identical ids.
5d. ``Trainer.train`` for 3 steps through each flash kernel built that 5-5c
   do not train, on the model whose attention has its shape (dropout 0.1 /
   0.1): bf16 and float32 at head_dim 32 (embed 512, 16 heads, 8 x 1024),
   float32 at 64 (the flagship with ``mixed_precision`` off, 8 x 2048) and
   at 128 (the embed-2048 architecture in float32, 4 x 2048); 8 launches a
   step each way, finite losses. Each float32 case prints its mean step time
   (steps 2-3) and ``profile_steps``' flash share; with ``--parent``, three
   more steps on the parent's flash library, then three on this one's.
6. The speculative kernel ``spec_decode`` (csrc/spec_decode.cu, one
   thread-block cluster of G blocks, G printed) against its plain PyTorch
   version in float32: identical tokens and stats, greedy and sampled,
   blocks 2, 3, 5 and 11 (2 and 11 with relative attention on) at 64 steps
   with cache 128 at the default widths, block 16 on a narrower model, and
   the main path's shape 1 x (10 + 1014), cache 1024, greedy at T=5 and
   sampled at T=3 (sampled only with relative attention on). Then its ids
   against ``decode_generate``'s at batch 1, equal bit
   for bit in float32 and bfloat16, relative attention off and on: greedy
   and sampled (top-k 30, top-p 0.9) at blocks 2, 3, 5 and 11, 64 steps with
   cache 128, and greedy T=5 and sampled T=3 at the main shape, where the
   kernel runs twice (a race between the blocks of its cluster shows as ids
   that differ only sometimes). Then ``generate_ids(engine="auto",
   temperature=0)`` at batch 1 with bfloat16 weights, on random weights and
   on phase 5's restored model (relative attention off): the speculative
   kernel's launch count must rise and the sequential kernel's must not,
   ids must lie in the vocabulary and equal ``engine="megakernel"``'s, and
   a MIDI file is written. Each bf16 run's tokens, and those of the timed
   kernel call, are teacher-forced through the plain version's bf16
   forward: every emitted token's logit must lie within 2% of the logits'
   scale of its row's maximum. The realized acceptance (tokens per
   generation block), events/s of both engines, and the kernel's (twice),
   the sequential kernel's and the plain version's times are printed, with
   the block / step ratio (the acceptance at which spec breaks even).
   ``python3 chip_smoke.py --parent <checkout>`` also builds that
   checkout's ``csrc/spec_decode.cu``, ``csrc/decode_wide.cu``,
   ``csrc/decode_wide_segment.cu`` and ``csrc/flash_attention.cu`` (the
   parent commit, unpacked with ``git archive`` into a directory
   ``.gitignore`` lists; ``parent_libraries``) and times them on the same
   inputs as this checkout's, parent, this, this, parent (here and in
   phases 8c and 9b; the float32 flash pair in ``flash_timings``, parent,
   this, parent, and phase 5d's float32 steps, this, parent, this).
7. The segmented decode kernel ``decode_segment`` (csrc/decode_segment.cu)
   and ``ContinuousGenerationService``. (a) Kernel against plain version in
   float32 at the default widths: 8 slots, ragged prompts, a slot parked
   throughout and two arriving mid-run, 64 steps cut into segments of 1, 7
   and 64, cache 128, relative attention off and on, greedy and sampled:
   ids and carry identical, and identical across the three cuts. Then the
   service's shape, 8 x (10 + 1014) in 16 segments of 64 with cache 2048:
   greedy, relative attention off, identical to the plain version and to
   one ``decode_generate`` launch; sampled, on, identical to one
   ``decode_generate`` launch. (b) bf16 at that shape:
   the kernel's ms per segment (CUDA events around each launch) against
   the plain version's and the bound, one ``decode_generate`` launch for
   the same generation (the cost of segmenting), the greedy ids'
   agreement with it, and the cluster size. (c) The service with the JAX
   ``serve`` defaults (8 slots, segments of 64, cache 2048, bf16) on the
   card: 16 requests of 10 + 1014 events submitted from 16 threads at
   once, 8 greedy and 8
   sampled with mixed top-k / top-p, so half wait for a slot. Every
   response must hold 1024 ids in the vocabulary, the kernel's launch count
   must rise, and each response's tokens, teacher-forced through the plain
   bf16 forward (a sampled row adding the kernel's Philox noise of its
   slot and global steps), must be ones the kernel could have picked with
   every logit within 1% of their scale of the plain version's
   (``sampled_token_gap``: the 2% rule, split between two lanes). The
   burst's events/s, the device's busy share (CUDA events around each
   segment against the device window) and the greedy responses' agreement
   with ``decode_generate`` are printed.

8. The wide decode kernel ``decode_wide`` (csrc/decode_wide.cu) and
   ``generate_ids``' wide route. (a) Kernel against plain version, 8 ragged
   rows x 150 steps at cache 256 (past the int8 K/V window at 128), greedy
   and sampled with per-row top-k / top-p: float32 weights give identical
   ids and last-step logits within 1e-3, at the default widths (relative
   attention off and on, where the ids also equal one ``decode_generate``
   launch; batch 1 x 600 steps, 8 key splits; int8 K/V) and at the
   embed-1024 flagship's (random weights from a numpy seed), where a second
   call on the reused K/V state equals a fresh one. int8 weights compute on
   bf16-rounded activations: their ids, teacher-forced through the plain
   version, must pass the bf16 rule (``wide_teacher_forced_gap``): with
   int8 K/V at the default widths, with and without on the flagship. (b)
   The flagship in bf16 through
   ``generate_ids(engine="auto")``, 8 x (10 + 1014) from a codec-encoded
   prompt and 1 x (10 + 1014), sampled: the wide kernel's launch count must
   rise and ``decode_generate``'s not, ids lie in the vocabulary, a MIDI file
   is written, and every token, teacher-forced through the plain bf16
   forward with the kernel's noise, passes ``sampled_token_gap``; events/s
   and the device's busy share are printed. (c) CUDA-event times at B=8 and
   B=1 of the kernel in bf16, int8 weights and int8 weights + int8 K/V
   against ``wide_bound``; the bf16 runs twice, whose ids must be
   identical (a race between blocks shows as ids that differ only
   sometimes); the kernel's own clock by phase with its grid barriers a
   step (``wide_clock_line``); with ``--parent``, the parent checkout's
   kernel on the same bf16 inputs (parent, this, this, parent; this one
   must be faster at both batches) and the agreement of its float32 greedy
   ids with this kernel's; the plain version (at B=8: it takes 15-20 s a
   call) and one ``decode_generate`` launch on the same weights (the route
   ``auto`` took before the wide kernel); then the default model's wide
   time beside ``decode_generate``'s.

9. The streamed-weight segment kernel ``decode_wide_segment``
   (csrc/decode_wide_segment.cu) and ``ContinuousGenerationService``'s wide
   engine. (a) Kernel against plain version in float32, at the default
   widths (relative attention off and on) and the flagship's: 8 slots,
   ragged prompts, one parked throughout and two arriving mid-run, 150
   steps at cache 256 cut into segments of 1, 7 and 64, greedy and sampled
   with per-row top-k / top-p: ids and carry identical, hence identical
   across the cuts; at the default widths they also equal
   ``decode_segment``'s, and greedy ids equal one ``decode_wide`` launch
   (each row from its own position 0). int8 weights on the flagship pass
   the bf16 rule teacher-forced (``wide_teacher_forced_gap``). (b) bf16 on
   the flagship, 8 x (10 + 1014) in 16 segments of 64 at cache 2048, run
   twice with identical ids: ms per segment (CUDA events around each
   launch) against the plain version, ``wide_segment_bound`` and one
   ``decode_wide`` launch for the same generation, with the greedy ids'
   agreement, and the first segment's clock; with ``--parent``, the parent
   checkout's kernel per segment on the same inputs (parent, this, this,
   parent; this one must be faster). (c)
   ``ContinuousGenerationService(engine="auto")`` on the flagship with the
   `serve` defaults must take the wide engine: a 16-request burst (8
   greedy, 8 sampled), the wide segment kernel's launch count rising and
   ``decode_segment``'s not, every token checked by ``sampled_token_gap``
   teacher-forced through the plain bf16 forward; events/s, latency p50 /
   p95 and the busy share are printed, and two segments of the resident
   route ``auto`` took before are timed on the same weights.

10. The HTTP layer: ``build_server(service, config, port=0)`` on loopback in
   a daemon thread, posted to with ``urllib`` (every call with a timeout),
   with the `serve` defaults (``max_batch_size`` 8, ``max_wait_ms`` 20,
   ``default_length`` 1024) and bf16 weights. (a) ``GenerationService`` on
   the default model, one greedy request of 10 + 1014 events: the
   speculative kernel launches once and ``decode_generate`` never,
   ``/v1/health`` shows ``spec_requests`` 1 with an acceptance, and the ids
   equal ``generate_ids(engine="megakernel")``'s. (b) A burst of 16 from 16
   threads, prompts of 10, 12 and 16 events (two of them ``midi_base64``
   files written by the port's codec, with ``prompt_length`` 10 and
   ``return_midi``), 1014 events each, 8 greedy and 8 sampled with mixed
   top-k / top-p: ``decode_generate`` launches, some batch holds more than
   one row, every response is its prompt and 1014 ids in the vocabulary,
   greedy responses equal their prompt's lone ``engine="megakernel"`` run,
   every token passes ``sampled_token_gap`` teacher-forced through the
   plain bf16 forward with the fused kernels' noise of (the batch's seed,
   padded row, step) (``served_token_gap``), and the MIDI responses
   decode; events/s, latency p50 / p95 from ``/v1/health`` and on the
   clients' clock, the batch sizes and the busy share (CUDA events around
   each launch) are printed.
   (c) ``ContinuousGenerationService`` behind the same handler: 4 streamed
   greedy requests launch ``decode_segment`` and their ndjson chunks
   concatenate to the blocking responses. (d) ``GenerationService`` on the
   flagship, 8 requests of 10 + 246 events at once (4 greedy, 4 sampled):
   ``decode_wide`` launches and nothing else, every token passes the same
   rule; events/s printed. (e) ``admission_prefill_case``:
   ``ContinuousGenerationService`` in float32 on the card, 100-event
   prompts give identical greedy ids token by token, with the admission
   prefill and from a prefix-cache hit, whose counter rises once.

11. The port's CLI, ``python -m composer_tpu_torch.cli``, as users run it,
   at the default model's full width (vocab 390, embed 256, 8 layers x 16
   heads, window 1024, batch 8, bf16): 24 MIDI files of 400 random notes
   (numpy seed 11, written by the port's codec); ``make-config``, then
   ``use_pallas_attention: true`` and batch 8 in that config;
   ``preprocess`` (transform and split: 16 train files in 160 ``.data``
   files, 8 test files); ``train -e 1``, whose flash launches must be 8 a
   step each way; ``evaluate`` (flash forward only); ``generate -l 1014
   --prompt-length 10`` from a MIDI prompt, sampled (one ``decode_generate``
   B=1 launch) and greedy (one ``spec_decode`` launch), each MIDI identical
   to ``generate_ids`` on the restored weights, and the sampled one again as
   a fresh process (its start-up); each command in process (``cli.main``),
   the wrappers' counts read around it. Then ``serve`` as a subprocess
   (every wait bounded, SIGINT at the end; it logs its launches): a lone
   greedy request must show in ``/v1/health``'s spec gauges and equal the
   in-process greedy run, and 8 sampled requests at once launch
   ``decode_generate`` B>1; and ``serve --continuous`` with one request
   launches ``decode_segment``. The rest of the CLI on the same corpus: the
   native codec (``composer_tpu_torch/native``, built by g++ beside the
   kernels) must be loaded and parse each of the 24 files into the Python
   parser's arrays; ``preprocess --no-transform -w 1`` in process with it
   and with the Python paths (identical ``.data`` trees, a host-only
   comparison of times); ``export-dataset`` of ``processed/``, whose
   batches must equal ``get_dataset``'s on the directory with shuffling
   off; ``evaluate`` on the ``.tfrecord`` (flash forwards only) and ``train
   -e 1`` from it (8 flash launches a step each way, finite losses);
   ``summary``, ``visualize-training``, ``synthesize --renderer builtin`` of
   the sampled MIDI (a WAV that is not silent); ``profile --steps 2
   --decode-length 64`` (24 flash backwards: a warm-up step and two traced,
   at least as many forwards, two ``decode_generate`` B=1 launches), whose
   Chrome trace must hold those kernels by name. Prints each command's wall
   time, the train step time and events/s, evaluate's loss, and generate's
   events/s.

12. MusicRNN (``rnn_path``) at the default config's widths (vocab 390,
   embed 256, 3 LSTM layers of 512, dropout 0.3, BatchNorm), bf16 compute:
   ``Trainer.train`` 8 steps of 64 x 200 on one fixed batch of codec-encoded
   ids (finite losses that fall; the BatchNorm statistics move on the card),
   ``profile_steps`` (the device's idle share), ``evaluate`` on 4 other
   batches, ``generate_ids`` at 8 x (10 + 1024) sampled (the shapes of
   ``composer_tpu/bench.py``'s RNN train and decode benchmarks); then the
   trained weights in float32 on the card against the same on the CPU:
   logits over 4 x 200 within 1e-4 of their scale (bf16 on the card within
   the 2% rule), and greedy 4 x (10 + 246) ids equal, or every card token
   within 2% of the logits' scale of its row's maximum. No TPU kernel lies
   on this path (the JAX package's LSTM is an XLA scan; the port's is
   cuDNN's), so no kernel's count moves. About 12 s.

13. The mesh on the one card (``mesh_path``): two gloo ranks, tensor and
   data parallel training, a checkpoint and ``GenerationService(mesh=)``.

14. The port's bench (``bench_path``, ``composer_tpu_torch/bench.py``):
   ``bench.headline()`` at full width (8 x (10 + 1014) and 1 x (10 + 1024)
   through ``generate_ids(engine="auto")``) must launch ``decode_generate``
   at B=8 and B=1, report on-device seconds (CUDA events) no larger
   than its wall seconds and, at B=8, within 10% of phase 3's kernel time;
   then every other ``run_*`` once at a size cut for time that still
   reaches its kernel (``BENCH_CASES``), each returning the schema with no
   error and the launches of the kernel it names; and the CLI's
   ``benchmark --length 64 --batch-size 8`` in process, one JSON line.

Prints the card line, a JSON line describing each kernel (with its bound:
the larger of bytes over 3.35 TB/s and operations over 989 TFLOP/s, the
H100 SXM's published peaks, the resident decode kernels' bytes counting
each step's weights and K/V prefixes again where they outgrow the 50 MB L2
(``kv_bytes``); the flash pair once for each
(dtype, head_dim) built, told apart by ``variant``, ``dtype`` and
``head_dim``, timed at ``shape``, its launches those of the phase that
trains through it (5, 5b, 5c or 5d); ``cluster``, the blocks a sequence took, for the cluster
kernels, else null; for the speculative, the two wide and the float32
flash kernels ``parent_ms``, the ``--parent`` checkout's times or null; for
the flash kernels ``library``, the SDPA backend timed as ``library_ms``, and
``train_step_ms``, phase 5d's step times; ``http_launches``,
the kernel's launches in phase 10 (a)-(d), read from its wrapper's count;
``cli_launches``, its launches in phase 11, in process and behind both
servers; ``mesh_launches``, each rank's in phase 13; ``bench_launches``,
phase 14's), then, as the last line,
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --flash-planted-faults

runs phase 4's rules on the sound flash kernels and on copies with faults
planted in far tiles (bf16 at D=16, 64 and 128, float32 at 64 and 128), and exits 0
only if the sound kernels pass and every fault fails in every case.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

F32_LOGIT_TOL = 1e-3  # f32, different summation orders
BF16_LOGIT_REL_TOL = 0.02  # bf16 roundings of intermediate activations
PROMPT_EVENTS = 10
GENERATE_EVENTS = 1014
FLASH_F32_TOL = 2e-4  # O and lse, absolute: f32, different summation orders
FLASH_F32_GRAD_TOL = 5e-4  # gradients, of their scale: atomics reorder the sums
FLASH_BF16_LSE_TOL = 1e-3  # lse, absolute: exact bf16 products summed in f32 on both sides
# bf16 rows (of O, dq, dk, dv, dE): each row's error against its own norm,
# floored at this share of the tensor's root-mean-square row norm (rows that
# cancel to near zero, such as dq's first, carry only rounding noise).
FLASH_ROW_FLOOR = 0.1
FLASH_SHAPE = (8, 16, 1024, 16, 1024)  # B, H, S, D, W of the training path
FLASH_FLAGSHIP_SHAPE = (8, 16, 2048, 64, 2048)  # the flagship's: 16 heads of 64, window 2048
# The embed-2048 architecture's (composer_tpu/bench.py:1559-1563): batch 4 x
# 2048, 16 heads of 128, window 2048.
FLASH_WIDE_SHAPE = (4, 16, 2048, 128, 2048)
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_WINDOW = 8, 1024
F32_TRAIN_STEPS = 3  # float32 steps: the split-TF32 flash kernels' route
FLAGSHIP_TRAIN_STEPS, FLAGSHIP_TRAIN_WINDOW = 5, 2048
# The embed-2048 architecture (composer_tpu/bench.py:1559-1563; README's
# scaled model): 8 layers x 16 heads of 128, window 2048, relative attention,
# batch 4 x 2048, lr 1e-3, flash attention, bf16 compute, dropout 0.
EMBED2048 = dict(vocab_size=390, embed_dim=2048, window_size=2048, num_layers=8, num_heads=16,
                 use_relative_attention=True)
EMBED2048_TRAIN_STEPS, EMBED2048_BATCH = 5, 4
EMBED2048_GENERATE_EVENTS = 246  # 10 + 246 at B=8, cut from 1014 for time
WIDTH_TRAIN_STEPS = 3  # phase 5d: steps through each remaining (dtype, head_dim) built
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate, published
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor rate, published
L2_BYTES = 50 * 2**20  # H100 SXM's 50 MB L2, taken in MiB: the larger, so bounds stay lower


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
    from composer_tpu_torch.config import get_default
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models import create_model
    from composer_tpu_torch.models.convert import params_from_flax

    config = get_default()
    config.transformer.model.use_relative_attention = use_relative
    model, _ = create_model(ModelType.TRANSFORMER, config, device=device)
    state = params_from_flax(random_flax_params(model.config, seed=0), model.config)
    model.load_state_dict({k: v.to(device) for k, v in state.items()})
    return model.eval(), config


def run_both(packed, config, prompts, plens, temps, topk, topp, *, length, cache_len,
             rows=(None, None), start_step=0, seed=0, kernel_runs=1):
    """(kernel ids, plain ids, max |logits difference| at the last step).
    With ``kernel_runs`` > 1 the kernel runs again on the same inputs and
    must give the same ids each time (a race between the blocks of a
    cluster shows as ids that differ only sometimes)."""
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
    for run in range(1, kernel_runs):
        if not torch.equal(decode_generate(*args, **kwargs), ours):
            raise AssertionError(f"the kernel's ids changed in run {run + 1} of one call")
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
        rng32 = np.random.default_rng(3)
        prompts32 = torch.as_tensor(rng32.integers(0, 390, (32, 9)), dtype=torch.int32,
                                    device=device)
        ragged32 = torch.as_tensor(rng32.integers(1, 10, 32), dtype=torch.int32, device=device)
        sampled32 = vectors(32, rng32.choice([0.0, 0.8, 1.0, 1.2], 32).astype(np.float32),
                            rng32.choice([0, 5, 40], 32),
                            rng32.choice([0.0, 0.9], 32).astype(np.float32))
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
            # 32 sequences: a cluster of 4 blocks each (cluster_size).
            ("B=32 greedy", prompts32, ragged32, vectors(32, 0.0, 0, 0.0), {}),
            ("B=32 ragged sampled", prompts32, ragged32, sampled32, {"seed": 12}),
        ]
        # The main path's shapes: 10 prompt + 1014 generated, cache 1024.
        main = torch.as_tensor(np.random.default_rng(2).integers(0, 390, (8, PROMPT_EVENTS)),
                               dtype=torch.int32, device=device)
        main_plens = torch.full((8,), PROMPT_EVENTS, dtype=torch.int32, device=device)
        # The main shapes' kernel runs twice: DSMEM races show as ids that
        # differ only sometimes.
        main_cases = (
            ("B=8 greedy", main, main_plens, greedy8, {}),
            ("B=8 sampled", main, main_plens, sampled8, {"seed": 10}),
            ("B=1 greedy", main[:1], main_plens[:1], vectors(1, 0.0, 0, 0.0), {}),
        )
        if use_relative:  # the plain version takes 8-10 s a case at this shape
            main_cases = main_cases[1:2]
        cases = [(*case, 64, 128) for case in cases] + [
            (f"{name} main shape", p, plens, vectors_, {**extra, "kernel_runs": 2},
             GENERATE_EVENTS, 1024)
            for name, p, plens, vectors_, extra in main_cases]
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
    from composer_tpu_torch.midi.events import Note, NoteSequence

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
    from composer_tpu_torch.midi.events import EventSequence

    EventSequence.from_ids(
        ids, config.dataset.time_step_increment, config.dataset.max_time_steps,
        config.dataset.velocity_bins,
    ).to_note_sequence().to_midi(str(path))
    return path.stat().st_size


class KernelSpans:
    """Stands in for a kernel's loaded library and records CUDA events around
    each call of its C entry points. The call only enqueues the kernel, so
    on the stream the two events bracket the kernel itself."""

    def __init__(self, lib):
        self.lib = lib
        self.spans = []

    def __getattr__(self, symbol):
        entry = getattr(self.lib, symbol)

        def call(*args):
            begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            err = entry(*args)
            end.record()
            self.spans.append((begin, end))
            return err

        return call

    def ms(self) -> float:
        """Device time of the recorded calls (synchronizes)."""
        torch.cuda.synchronize()
        return sum(begin.elapsed_time(end) for begin, end in self.spans)


def main_path(device, card: str) -> dict:
    """Phase 3: the serving path through its user entry point."""
    from composer_tpu_torch.models import ModelType
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
        kernel_ms = kernel_spans.ms()
        return ids, wall, window[0].elapsed_time(window[1]), kernel_ms

    prefills = []
    decode_generate.launches_batched = 0
    decode_generate.launches_single = 0
    ids8, *_ = generate(model, batch8, GENERATE_EVENTS, seed=1)  # packs the weights
    ids8, wall8, window8, kernel8 = generate(model, batch8, GENERATE_EVENTS, seed=2)
    clusters = {"batched": decode_generate.cluster}
    ids1, wall1, window1, kernel1 = generate(model, prompt, GENERATE_EVENTS, seed=3)
    clusters["single"] = decode_generate.cluster
    engine = gen._packed_engine(model, None)
    original = engine._prefill_rows
    engine._prefill_rows = lambda *a: prefills.append(a[0].shape) or original(*a)
    ids_long, *_ = generate(model, np.tile(long_prompt, (8, 1)), 256, seed=4)
    ids_rel, *_ = generate(rel_model, batch8, GENERATE_EVENTS, seed=5)
    launches = {"batched": decode_generate.launches_batched,
                "single": decode_generate.launches_single}
    _build.load_library = load_library

    print(f"main path launches {launches}, prefill calls {prefills}; cluster size G "
          f"(ops/decode_kernel_batched.py::cluster_size): B=8 {clusters['batched']}, "
          f"B=1 {clusters['single']}", flush=True)
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
    return {"launches": launches, "engine": engine, "prompt": prompt, "clusters": clusters}


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
        print(f"B={batch} bf16 main shape: sampled ids agreement={agree:.4f}", flush=True)
        if batch > 1:  # B=1 is phase 2's f32 main shapes (the plain run takes 8 s)
            forced = torch.cat([prompts, plain], dim=1)[:, :num_steps].contiguous()
            widths = torch.full((batch,), num_steps, dtype=torch.int32, device=device)
            _, _, err, logits = run_both(engine.packed, engine.config, forced, widths, temps,
                                         topk, topp, length=1, cache_len=1024)
            scale = float(logits[:, :engine.config.vocab_size].abs().max())
            print(f"B={batch} bf16 main shape: teacher-forced last-step logits "
                  f"max_abs_err={err:.3e} (scale {scale:.3f})", flush=True)
            if err > BF16_LOGIT_REL_TOL * scale:
                raise AssertionError(f"bf16 logits differ by {err} > {BF16_LOGIT_REL_TOL} x "
                                     f"{scale}")
        result[form] = (kernel_ms, plain_ms)
        steps_ms = {start: steps_from_ms(engine, batch, start, device) for start in (0, 960)}
        print(f"B={batch} bf16, 64 steps (CUDA events, teacher-forced): from position 0 "
              f"{steps_ms[0]:.3f} ms ({steps_ms[0] / 64 * 1e3:.1f} us a step), from 960 "
              f"{steps_ms[960]:.3f} ms ({steps_ms[960] / 64 * 1e3:.1f} us a step); cluster size "
              f"{decode_generate.cluster} [{card}]", flush=True)
        result[f"{form} steps"] = steps_ms
    return result


def steps_from_ms(engine, batch: int, start: int, device, steps: int = 64) -> float:
    """``decode_generate``'s time for ``steps`` steps from position
    ``start`` at the main path's cache (1024) in bf16, teacher-forced (the
    step still samples), over a prefilled cache of random rows: at 0 the
    weights take most of a step, at 960 the attention over the prefix
    adds its share."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate

    config = engine.config
    width = start + steps
    rng = np.random.default_rng(start + batch)
    prompts = torch.as_tensor(rng.integers(0, config.vocab_size, (batch, width)),
                              dtype=torch.int32, device=device)
    plens = torch.full((batch,), width, dtype=torch.int32, device=device)
    temps, topk, topp = dk.row_params(batch, 512, 1.0, 0, 0.0, False, False, False, device)
    shape = (config.num_layers, batch * 1024, config.embed_dim)
    rows = [torch.randn(shape, device=device).mul_(0.5).to(torch.bfloat16) for _ in range(2)]
    if not start:
        rows = [None, None]
    kwargs = dict(config=config, num_steps=width, out_len=1, cache_len=1024, start_step=start)
    return cuda_ms(lambda: decode_generate(engine.packed, prompts, plens, 0, temps, topk, topp,
                                           *rows, **kwargs), 5)


def bound(byte_count: float, flops: float, flops_per_s: float = BF16_FLOPS):
    """``(ms, "bytes" | "operations")``: the least time for the work on an
    H100 SXM at its published memory rate and ``flops_per_s`` (the bf16
    tensor rate unless another is named)."""
    by_bytes, by_ops = byte_count / HBM_BYTES_PER_S, flops / flops_per_s
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def kv_bytes(packed, config, prefix_rows, band_rows, written: int) -> int:
    """HBM bytes of the resident kernels beyond the packed weights' one read:
    each K/V row written once (``written`` rows in every layer) and, at each
    step, the part of that step's working set that the L2 cannot hold read
    again. ``prefix_rows[i]`` and ``band_rows[i]`` are the K/V rows (the
    prefixes [0, pos] of every active sequence) and the relative band's rows
    that step i reads in every layer; its working set is those and the
    packed weights. A step that reads W bytes which the step before also
    read must fetch at least W - ``L2_BYTES`` of them from HBM, whatever
    the cache keeps (the weights are reread through the L2 every step, as
    the resident kernels do). Where the working set fits (B=1, the
    speculative kernel), the K/V rows cost their one write and nothing
    more; at B=8 the cache outgrows the L2 beside the weights from about
    position 600."""
    E, L = config.embed_dim, config.num_layers
    row = L * 2 * E * packed["wte"].element_size()
    band_row = L * E * packed["rel_rows"].element_size() if config.use_relative_attention else 0
    table = packed["rel_rows"].numel() * packed["rel_rows"].element_size()
    weights = sum(t.numel() * t.element_size() for t in packed.values()) - table
    working = (weights + np.asarray(prefix_rows, np.int64) * row
               + np.asarray(band_rows, np.int64) * band_row)
    return written * row + int(np.maximum(working - L2_BYTES, 0).sum())


def decode_bound(engine, batch: int, num_steps: int):
    """One generation call: the packed weights and prompts read once, the
    ids written once; per step, layer and sequence its K/V prefix [0, pos]
    read again where the L2 cannot hold it beside the weights, and its K/V
    row written (``kv_bytes``); per step and sequence the layer GEMVs (24 E^2 per
    layer), attention over the grown prefix (4 or, with the relative band,
    6 x keys x E per layer) and the tied logits."""
    config = engine.config
    E, L, W = config.embed_dim, config.num_layers, config.window_size
    weights = sum(t.numel() * t.element_size() for t in engine.packed.values())
    ids = batch * (PROMPT_EVENTS + num_steps + 1) * 4
    per_key = 6 if config.use_relative_attention else 4
    steps = np.arange(num_steps)
    keys = int((steps + 1).sum())  # sum over steps of (position + 1)
    flops = batch * (num_steps * (L * 24 * E * E + 2 * E * config.vocab_size)
                     + L * per_key * E * keys)
    kv = kv_bytes(engine.packed, config, batch * (steps + 1), np.minimum(steps + 1, W),
                  batch * num_steps)
    return bound(weights + ids + kv, flops)


def flash_bound(shape, use_rel: bool, backward: bool, dtype=torch.bfloat16):
    """One flash call at ``shape`` (B, H, S, D, W). Forward reads q, k, v
    (and E) and writes O and lse; the backward reads q, k, v, O, dO, lse
    (and E) and writes dq, dk, dv (and dE). Products over the causal pairs,
    2 D operations each: QK^T and PV (plus the band q.E) forward; the
    recomputed QK^T, dO V^T, P^T dO, dS K and dS^T Q (plus the band's
    recompute, dq and dE) backward. bf16 at the tensor-core rate; float32
    at a third of the TF32 rate, the least a float32-accurate product takes
    on the tensor cores (three TF32 products, split TF32)."""
    B, H, S, D, W = shape
    elem_bytes = torch.tensor([], dtype=dtype).element_size()
    tensor = B * H * S * D * elem_bytes
    table = H * W * D * elem_bytes if use_rel else 0
    rows = B * H * S * 4
    pairs = B * H * S * (S + 1) // 2
    if backward:
        byte_count, products = 8 * tensor + rows + 2 * table, 5 + 3 * use_rel
    else:
        byte_count, products = 4 * tensor + rows + table, 2 + use_rel
    return bound(byte_count, products * 2 * D * pairs,
                 BF16_FLOPS if dtype == torch.bfloat16 else TF32_FLOPS / 3)


def flash_inputs(dtype, use_rel: bool, device, seed: int, shape=FLASH_SHAPE):
    """q, k, v, E (or None) and a cotangent at ``shape`` (B, H, S, D, W),
    from a numpy seed."""
    B, H, S, D, W = shape
    rng = np.random.default_rng(seed)

    def tensor(*shape, std=1.0):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32) * std).to(device, dtype)

    q, k, v, dout = (tensor(B, H, S, D) for _ in range(4))
    return q, k, v, tensor(H, W, D, std=0.25) if use_rel else None, dout


def flash_shape(depth: int) -> tuple:
    """The training path's flash shape (B=8, H=16, S=W=1024) at another
    head_dim: embed 16 x ``depth``."""
    return FLASH_SHAPE[:3] + (depth,) + FLASH_SHAPE[4:]


# What phase 4 checks, each (dtype, head_dim) built at the shapes the main
# path gives it (phases 5, 5b, 5c, 5d), and head_dims the wrapper pads: bf16
# 48 to the D=64 kernels, float32 24 to the D=32 ones: (dtype, shape) ->
# (route, head_dim) of ops/flash_attention.py::VARIANTS.
FLASH_CHECKS = ((torch.float32, FLASH_SHAPE), (torch.bfloat16, FLASH_SHAPE),
                (torch.bfloat16, FLASH_FLAGSHIP_SHAPE), (torch.bfloat16, FLASH_WIDE_SHAPE),
                (torch.bfloat16, flash_shape(32)), (torch.float32, flash_shape(32)),
                (torch.float32, FLASH_FLAGSHIP_SHAPE), (torch.float32, FLASH_WIDE_SHAPE),
                (torch.bfloat16, flash_shape(48)), (torch.float32, flash_shape(24)))
# The shape each (route, head_dim) built is timed at (``flash_timings``).
FLASH_TIMED = {("mma", 16): FLASH_SHAPE, ("mma", 32): flash_shape(32),
               ("mma", 64): FLASH_FLAGSHIP_SHAPE, ("mma", 128): FLASH_WIDE_SHAPE,
               ("tf32x3", 16): FLASH_SHAPE, ("tf32x3", 32): flash_shape(32),
               ("tf32x3", 64): FLASH_FLAGSHIP_SHAPE, ("tf32x3", 128): FLASH_WIDE_SHAPE}


def flash_row_error(ours, plain) -> float:
    """The largest ``|ours - plain|`` over the last axis's rows, each against
    ``max(its plain row's norm, FLASH_ROW_FLOOR x the tensor's RMS row
    norm)``."""
    diff = torch.linalg.vector_norm(ours.float() - plain.float(), dim=-1)
    norm = torch.linalg.vector_norm(plain.float(), dim=-1)
    floor = FLASH_ROW_FLOOR * float(norm.square().mean().sqrt())
    return float((diff / norm.clamp(min=floor)).max())


def flash_errors(name: str, dtype, ours, plain):
    """``(report, fault)`` of one flash output against its plain version.
    The report holds ``max_abs_err``, ``scale`` (max |plain|) and, for bf16
    rows, ``row_rel_err``; ``fault`` says which limit it broke, else None.
    float32: O and lse within FLASH_F32_TOL, gradients within
    FLASH_F32_GRAD_TOL x scale. bf16: lse within FLASH_BF16_LSE_TOL; every
    other output within the bf16 rule both of its scale and, row by row, of
    the row's own norm (``flash_row_error``)."""
    err = float((ours.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    report = {"max_abs_err": err, "scale": scale}
    if dtype == torch.bfloat16 and name == "lse":
        limit = FLASH_BF16_LSE_TOL
    elif dtype == torch.bfloat16:
        limit = BF16_LOGIT_REL_TOL * scale
        report["row_rel_err"] = flash_row_error(ours, plain)
        if not report["row_rel_err"] <= BF16_LOGIT_REL_TOL:
            return report, (f"{name}: a row differs by {report['row_rel_err']} of its norm "
                            f"> {BF16_LOGIT_REL_TOL}")
    elif name in ("O", "lse"):
        limit = FLASH_F32_TOL
    else:
        limit = FLASH_F32_GRAD_TOL * scale
    return report, None if err <= limit else f"{name} differs by {err} > {limit}"


def flash_case(fa, dtype, shape, use_rel: bool, rate: float, device, label: str) -> dict:
    """One phase-4 case: the flash kernels and their plain version on the
    same inputs; returns ``{output name: (report, fault)}`` and prints it."""
    seed = torch.tensor([20240611], dtype=torch.int32, device=device)
    q, k, v, e, dout = flash_inputs(dtype, use_rel, device, seed=3, shape=shape)
    kw = dict(scale=True, dropout_rate=rate, dropout_seed=seed if rate else None)
    out, lse = fa.flash_attention_forward(q, k, v, e, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, e, **kw)
    # Both backwards start from the plain forward's O and lse.
    grads = fa.flash_attention_backward(q, k, v, e, ref_out, ref_lse, dout, **kw)
    ref_grads = fa.flash_attention_backward_reference(q, k, v, e, ref_out, ref_lse, dout, **kw)
    torch.cuda.synchronize()
    pairs = [("O", out, ref_out), ("lse", lse, ref_lse)] + [
        (name, ours, plain) for name, ours, plain in zip(("dq", "dk", "dv", "dE"), grads,
                                                         ref_grads) if plain is not None]
    results = {name: flash_errors(name, dtype, ours, plain) for name, ours, plain in pairs}
    print(f"{label} {str(dtype)[6:]} B,H,S,D,W={shape} rel={use_rel} dropout={rate}: " + ", ".join(
        f"{name} {r['max_abs_err']:.2e} (scale {r['scale']:.2f}"
        + (f", row {r['row_rel_err']:.2e}" if "row_rel_err" in r else "") + ")"
        + (" FAILS" if fault else "") for name, (r, fault) in results.items()), flush=True)
    return results


def flash_vs_plain(device) -> dict:
    """Phase 4; returns, by ``(route, head_dim)`` (the head_dim as called:
    48 runs the D=64 kernels) and direction (``fwd``: O, lse; ``bwd``: dq,
    dk, dv, dE), the largest absolute error with its tensor's scale and, for
    bf16, the largest row error of its norm."""
    from composer_tpu_torch.ops import flash_attention as fa

    errors = {}
    before = (sum(fa.flash_attention_forward.launches.values()),
              sum(fa.flash_attention_backward.launches.values()))
    for dtype, shape in FLASH_CHECKS:
        variant = (fa.ROUTES[dtype], shape[3])
        worst = errors.setdefault(variant, {})
        for use_rel in (False, True):
            for rate in (0.0, 0.1):
                results = flash_case(fa, dtype, shape, use_rel, rate, device,
                                     f"flash {variant[0]}")
                for name, (report, fault) in results.items():
                    if fault:
                        raise AssertionError(f"flash {dtype} {shape} rel={use_rel} "
                                             f"dropout={rate}: {fault}")
                    into = worst.setdefault("fwd" if name in ("O", "lse") else "bwd",
                                            {"max_abs_err": 0.0, "scale": 0.0})
                    if report["max_abs_err"] >= into["max_abs_err"]:
                        into.update(max_abs_err=report["max_abs_err"], scale=report["scale"])
                    if "row_rel_err" in report:
                        into["row_rel_err"] = max(into.get("row_rel_err", 0.0),
                                                  report["row_rel_err"])
    launched = (sum(fa.flash_attention_forward.launches.values()) - before[0],
                sum(fa.flash_attention_backward.launches.values()) - before[1])
    if launched != (4 * len(FLASH_CHECKS),) * 2:
        raise AssertionError(f"flash launch counters did not rise by "
                             f"{4 * len(FLASH_CHECKS)} each: {launched}")
    return errors


def planted_fault(kind: str, where: str) -> tuple:
    """Edits ``(file, text, replacement)`` that plant a fault in a copy of
    the flash kernels (the bf16 and the float32 split-TF32 ones, at every
    head_dim), confined to the q-tile/k-tile pairs where the C
    condition ``where`` (on ``ib``, ``jb`` and ``bh``) holds: ``"band"``
    shifts the staged band by one row, ``"dropout"`` swaps two neighbouring
    Philox words, forward and backward."""
    if kind == "band":
        return (("flash_attention_mma.cuh",
                 "a.window - kBlock - (ib - jb) * kBlock, a.window);",
                 f"a.window - kBlock - (ib - jb) * kBlock + ({where}), a.window);"),
                ("flash_attention_mma.cuh",
                 "W - kBlock - (ib - jb) * kBlock, W);",
                 f"W - kBlock - (ib - jb) * kBlock + ({where}), W);"),
                ("flash_attention_tf32.cuh",
                 "a.window - kBlock - (ib - jb) * kBlock,",
                 f"a.window - kBlock - (ib - jb) * kBlock + ({where}),"),
                ("flash_attention_tf32.cuh",
                 "W - kBlock - (ib - jb) * kBlock, W);",
                 f"W - kBlock - (ib - jb) * kBlock + ({where}), W);"))
    return (("flash_attention_mma.cuh",
             "const unsigned w[4] = {wg.x, wg.y, wh.x, wh.y};",
             f"const bool swap = {where};\n"
             "        const unsigned w[4] = {swap ? wg.y : wg.x, swap ? wg.x : wg.y, wh.x, wh.y};"),
            ("flash_attention_mma.cuh",
             "words[c] = slot[4 * (4 * (4 * grp + c) + t) + 16 * grp + cl];",
             "words[c] = slot[4 * (4 * (4 * grp + c) + t) + 16 * grp + cl];\n"
             f"        if ({where}) {{ const unsigned w0 = words[0]; words[0] = words[1]; "
             "words[1] = w0; }"),
            ("flash_attention_tf32.cuh",
             "const unsigned w[4] = {wg.x, wg.y, wh.x, wh.y};",
             f"const bool swap = {where};\n"
             "        const unsigned w[4] = {swap ? wg.y : wg.x, swap ? wg.x : wg.y, wh.x, wh.y};"),
            ("flash_attention_tf32.cuh",
             "words[c] = drop_w[4 * (4 * (4 * grp + c) + t) + 16 * grp + cl];",
             "words[c] = drop_w[4 * (4 * (4 * grp + c) + t) + 16 * grp + cl];\n"
             f"        if ({where}) {{ const unsigned w0 = words[0]; words[0] = words[1]; "
             "words[1] = w0; }"))


# Where each fault lies: every tile pair 4 or more apart, or (at S=1024, 16
# tiles) the one pair of the last q-tile and the first k-tile of one head
# (at S=2048, the pairs 15 to 31 tiles apart of one head).
FLASH_PLANTED_FAULTS = {
    f"{kind}, {label}": planted_fault(kind, where) for kind in ("band", "dropout")
    for label, where in (("tiles 4+ apart", "ib - jb >= 4"),
                         ("tiles 15+ apart, head 0", "ib - jb >= 15 && bh == 0"))}


# What each planted fault is run at: the bf16 kernels at head_dim 16, 64 and
# 128 (the split backward) and the float32 split-TF32 kernels at 64 and 128
# (the split backward, its single-buffered q-tile), each at its main-path
# shape, with the band and dropout 0.1.
FLASH_FAULT_CASES = ((torch.bfloat16, FLASH_SHAPE), (torch.bfloat16, FLASH_FLAGSHIP_SHAPE),
                     (torch.bfloat16, FLASH_WIDE_SHAPE), (torch.float32, FLASH_FLAGSHIP_SHAPE),
                     (torch.float32, FLASH_WIDE_SHAPE))


def flash_planted_faults(device, card: str) -> int:
    """``--flash-planted-faults``: phase 4's rules on the sound flash
    kernels and on each of ``FLASH_PLANTED_FAULTS``, built (one nvcc each,
    at once) from copies of csrc/ under build/planted/, at each of
    ``FLASH_FAULT_CASES``. Returns 0 when the sound kernels pass and every
    planted fault fails the rule in every case; prints, for bf16, whether
    the rule of scale alone (each element within 2% of its tensor's largest
    value) would have passed."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from composer_tpu_torch.ops import _build
    from composer_tpu_torch.ops import flash_attention as fa

    sound = _build.CSRC
    faults = (("sound", ()),) + tuple(FLASH_PLANTED_FAULTS.items())
    copies = []
    for index, (fault, edits) in enumerate(faults):
        csrc = sound
        if edits:
            csrc = _build.BUILD_DIR.parent / "planted" / str(index) / "csrc"
            shutil.rmtree(csrc, ignore_errors=True)
            shutil.copytree(sound, csrc)
            for name, text, replacement in edits:
                source = (csrc / name).read_text()
                if source.count(text) != 1:
                    raise AssertionError(f"planted fault {fault!r}: {text!r} not found once "
                                         f"in {name}")
                (csrc / name).write_text(source.replace(text, replacement))
        copies.append(csrc)
    with ThreadPoolExecutor(len(copies)) as pool:
        list(pool.map(lambda csrc: _build.build("flash_attention", csrc), copies))
    as_intended = True
    try:
        for (fault, edits), csrc in zip(faults, copies):
            _build.CSRC = csrc
            _build._LIBRARIES.pop("flash_attention", None)
            _build.load_library("flash_attention")
            for dtype, shape in FLASH_FAULT_CASES:
                results = flash_case(fa, dtype, shape, True, 0.1, device,
                                     f"flash fault {fault!r}")
                failed = [f for _, f in results.values() if f]
                scale_rule = all(report["max_abs_err"] <= BF16_LOGIT_REL_TOL * report["scale"]
                                 for name, (report, _) in results.items() if name != "lse")
                print(f"flash fault {fault!r} {str(dtype)[6:]} B,H,S,D,W={shape}: "
                      + (f"the rule of scale alone {'passes' if scale_rule else 'fails'}; "
                         if dtype == torch.bfloat16 else "")
                      + "phase 4's rule "
                      + ("fails (" + "; ".join(failed) + ")" if failed else "passes")
                      + f" [{card}]", flush=True)
                as_intended &= bool(failed) == bool(edits)
    finally:
        _build.CSRC = sound
        _build._LIBRARIES.pop("flash_attention", None)
    print(f"planted faults: {'every one fails phase 4' if as_intended else 'NOT AS INTENDED'}",
          flush=True)
    return 0 if as_intended else 1


def training_corpus(config, events: int) -> np.ndarray:
    """Event ids encoded by the MIDI codec from NoteSequences of random
    notes (numpy seed 0), at least ``events`` long."""
    from composer_tpu_torch.midi.events import Note, NoteSequence

    rng = np.random.default_rng(0)
    chunks, total = [], 0
    while total < events:
        count = 2000
        starts = np.cumsum(rng.integers(0, 400, count))
        lengths = rng.integers(50, 1500, count)
        pitches, velocities = rng.integers(36, 96, count), rng.integers(20, 127, count)
        notes = [Note(float(s), float(s + d), int(p), int(v))
                 for s, d, p, v in zip(starts, lengths, pitches, velocities)]
        ids = NoteSequence(notes).to_event_sequence(
            config.dataset.time_step_increment, config.dataset.max_time_steps,
            config.dataset.velocity_bins).to_ids()
        chunks.append(ids.astype(np.int32))
        total += ids.size
    return np.concatenate(chunks)


def reset_flash_counts() -> None:
    from composer_tpu_torch.ops import flash_attention as fa

    for wrapper in (fa.flash_attention_forward, fa.flash_attention_backward):
        wrapper.launches = dict.fromkeys(wrapper.launches, 0)


def flash_counts(variant) -> tuple:
    """(forward, backward) launches of one route since the last reset."""
    from composer_tpu_torch.ops import flash_attention as fa

    return (fa.flash_attention_forward.launches[variant],
            fa.flash_attention_backward.launches[variant])


def timed_train(trainer, state, dataset, logdir):
    """``Trainer.train`` for one epoch with the host clock around each step
    (after a synchronize); returns ``(state, step seconds, losses, the
    trainer's events_per_second scalar)``."""
    step_seconds = []
    train_step = trainer.train_step

    def timed_step(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = train_step(*args, **kwargs)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - start)
        return metrics

    trainer.train_step = timed_step
    try:
        state = trainer.train(dataset, state, logdir, epochs=1, show_progress_bar=False)
    finally:
        del trainer.train_step  # later callers run the step without the timing syncs
    rows = [json.loads(line) for line in
            (Path(logdir) / "train" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in sorted(rows, key=lambda r: r["step"]) if r["name"] == "loss"]
    scalar = [r["value"] for r in rows if r["name"] == "events_per_second"][0]
    return state, step_seconds, losses, scalar


def train_path(device, card: str, prompt) -> dict:
    """Phase 5: ``Trainer.train`` through the flash kernels, checkpoint,
    restore in a fresh Trainer, generate with the restored model; then a
    few float32 steps, the split-TF32 kernels' route."""
    from composer_tpu_torch.config import get_default
    from composer_tpu_torch.data import WindowDataset
    from composer_tpu_torch.models import ModelType, create_model
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.train import generate as gen
    from composer_tpu_torch.train.checkpoint import CheckpointManager
    from composer_tpu_torch.train.trainer import Trainer

    results = {"launches": {("mma", 16): (0, 0), ("tf32x3", 16): (0, 0)}, "restored": None}
    expected = (TRAIN_STEPS * 8,) * 2  # layers x steps, each way
    for use_relative in (False, True):
        config = get_default()
        config.transformer.model.use_pallas_attention = True
        config.transformer.model.use_relative_attention = use_relative
        model, _ = create_model(ModelType.TRANSFORMER, config, device=device)
        if model.config.dtype != torch.bfloat16 or model.config.num_layers != 8:
            raise AssertionError(f"unexpected training config: {model.config}")
        events = TRAIN_BATCH * (TRAIN_WINDOW + 1) * TRAIN_STEPS
        corpus = training_corpus(config, events)[:events]
        dataset = WindowDataset(corpus, TRAIN_BATCH, TRAIN_WINDOW, shuffle=True, seed=0)
        if len(dataset) != TRAIN_STEPS:
            raise AssertionError(f"{len(dataset)} batches, wanted {TRAIN_STEPS}")
        trainer = Trainer(model, ModelType.TRANSFORMER, learning_rate=1e-3, seed=0,
                          device=device)
        state = trainer.init_state(TRAIN_BATCH, TRAIN_WINDOW)
        with tempfile.TemporaryDirectory() as tmp:
            reset_flash_counts()
            state, step_seconds, losses, scalar = timed_train(trainer, state, dataset, tmp)
            launches = flash_counts(("mma", 16))
            steps = CheckpointManager(tmp).steps()

            fresh, _ = create_model(ModelType.TRANSFORMER, config, device=device)
            restored = Trainer(fresh, ModelType.TRANSFORMER, learning_rate=1e-3,
                               device=device).restore(tmp, TRAIN_BATCH, TRAIN_WINDOW)
        trained = state.model.state_dict()
        same = all(torch.equal(t, trained[name])
                   for name, t in restored.model.state_dict().items())
        generated_before = decode_generate.launches_batched
        ids = gen.generate_ids(restored.model, ModelType.TRANSFORMER, None,
                               np.tile(prompt, (8, 1)), length=64, temperature=1.0,
                               engine="auto", seed=7)
        decode_launches = decode_generate.launches_batched - generated_before

        mean_step = float(np.mean(step_seconds[1:]))
        print(f"train rel={use_relative}: {len(losses)} steps, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, flash (bf16 tensor-core) launches fwd {launches[0]} bwd "
              f"{launches[1]}, checkpoints {steps}, restored equal={same}, generated "
              f"{ids.shape} with {decode_launches} decode launch(es)", flush=True)
        print(f"train rel={use_relative} step time {mean_step * 1e3:.2f} ms (steps 2-"
              f"{TRAIN_STEPS}, host clock after synchronize; min {min(step_seconds[1:]) * 1e3:.2f}"
              f", max {max(step_seconds[1:]) * 1e3:.2f}), {TRAIN_BATCH * TRAIN_WINDOW / mean_step:.1f}"
              f" train events/s; step 1 {step_seconds[0] * 1e3:.2f} ms; the trainer's "
              f"events_per_second scalar {scalar:.1f} [{card}]", flush=True)
        if launches != expected:
            raise AssertionError(f"flash launches {launches}, wanted {expected}")
        if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"bad losses: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
        if steps != [TRAIN_STEPS] or not same:
            raise AssertionError(f"checkpoint steps {steps}, restored equal {same}")
        if decode_launches < 1 or ids.shape != (8, PROMPT_EVENTS + 64) or ids.min() < 0 \
                or ids.max() >= 390:
            raise AssertionError(f"generation after restore failed: {ids.shape}, "
                                 f"{decode_launches} launches")
        profile_steps(trainer, state, dataset, card)
        total = results["launches"][("mma", 16)]
        results["launches"][("mma", 16)] = (total[0] + launches[0], total[1] + launches[1])
        if not use_relative:
            results["restored"] = restored.model.eval()

    # float32 compute (mixed_precision off): the split-TF32 kernels' route.
    config = get_default()
    config.transformer.model.use_pallas_attention = True
    config.transformer.model.use_relative_attention = True
    model, _ = create_model(ModelType.TRANSFORMER, config, device=device, dtype=torch.float32)
    events = TRAIN_BATCH * (TRAIN_WINDOW + 1) * F32_TRAIN_STEPS
    dataset = WindowDataset(training_corpus(config, events)[:events], TRAIN_BATCH, TRAIN_WINDOW,
                            shuffle=True, seed=0)
    trainer = Trainer(model, ModelType.TRANSFORMER, learning_rate=1e-3, seed=0, device=device)
    state = trainer.init_state(TRAIN_BATCH, TRAIN_WINDOW)
    with tempfile.TemporaryDirectory() as tmp:
        reset_flash_counts()
        state, step_seconds, losses, _ = timed_train(trainer, state, dataset, tmp)
        launches = flash_counts(("tf32x3", 16))
    mean_step = float(np.mean(step_seconds[1:]))
    print(f"train f32 rel=True: {len(losses)} steps, losses {[round(x, 4) for x in losses]}, "
          f"flash (f32 tf32x3) launches fwd {launches[0]} bwd {launches[1]}; step time "
          f"{mean_step * 1e3:.2f} ms (steps 2-{F32_TRAIN_STEPS}), "
          f"{TRAIN_BATCH * TRAIN_WINDOW / mean_step:.1f} train events/s [{card}]", flush=True)
    if launches != (F32_TRAIN_STEPS * 8,) * 2:
        raise AssertionError(f"f32 flash launches {launches}, wanted {F32_TRAIN_STEPS * 8} each")
    if len(losses) != F32_TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"bad f32 losses: {losses}")
    results["launches"][("tf32x3", 16)] = launches
    return results


def flagship_train_path(device, card: str) -> dict:
    """Phase 5b: ``Trainer.train`` on the embed-1024 flagship (8 layers x 16
    heads of 64, window 2048, relative attention) with its flash recipe:
    ``use_pallas_attention``, bf16 compute (``mixed_precision``), dropout
    0.1 / 0.1, batch 8 x 2048, lr 1e-3, on codec-encoded event ids."""
    from composer_tpu_torch.config import get_default
    from composer_tpu_torch.data import WindowDataset
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.train.trainer import Trainer

    config = TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16, attention_dropout_rate=0.1,
                               residual_dropout_rate=0.1, use_pallas_attention=True)
    steps, window = FLAGSHIP_TRAIN_STEPS, FLAGSHIP_TRAIN_WINDOW
    events = TRAIN_BATCH * (window + 1) * steps
    dataset = WindowDataset(training_corpus(get_default(), events)[:events], TRAIN_BATCH, window,
                            shuffle=True, seed=0)
    if len(dataset) != steps:
        raise AssertionError(f"{len(dataset)} batches, wanted {steps}")
    trainer = Trainer(Transformer(config), ModelType.TRANSFORMER, learning_rate=1e-3, seed=0,
                      device=device)
    state = trainer.init_state(TRAIN_BATCH, window)
    with tempfile.TemporaryDirectory() as tmp:
        reset_flash_counts()
        state, step_seconds, losses, scalar = timed_train(trainer, state, dataset, tmp)
        launches = flash_counts(("mma", 64))
    mean_step = float(np.mean(step_seconds[1:]))
    print(f"flagship train: {len(losses)} steps, losses {[round(x, 4) for x in losses]}, flash "
          f"(bf16 tensor-core, head_dim 64) launches fwd {launches[0]} bwd {launches[1]}",
          flush=True)
    print(f"flagship train step time {mean_step * 1e3:.2f} ms (steps 2-{steps}, host clock after "
          f"synchronize; min {min(step_seconds[1:]) * 1e3:.2f}, max "
          f"{max(step_seconds[1:]) * 1e3:.2f}), {TRAIN_BATCH * window / mean_step:.1f} train "
          f"events/s; step 1 {step_seconds[0] * 1e3:.2f} ms; the trainer's events_per_second "
          f"scalar {scalar:.1f} [{card}]", flush=True)
    if launches != (steps * FLAGSHIP["num_layers"],) * 2:
        raise AssertionError(f"flagship flash launches {launches}, wanted "
                             f"{steps * FLAGSHIP['num_layers']} each")
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"bad flagship losses: {losses}")
    profile_steps(trainer, state, dataset, card)
    return {"launches": launches, "step_ms": mean_step * 1e3}


def embed2048_train_path(device, card: str, yaml_config) -> dict:
    """Phase 5c: ``Trainer.train`` on the embed-2048 architecture
    (``EMBED2048``: 16 heads of 128) with ``use_pallas_attention``, bf16
    compute, dropout 0, batch 4 x 2048, lr 1e-3, on codec-encoded event ids:
    the tensor-core kernels at head_dim 128 must launch 8 x 5 times each way;
    then one step at the flagship recipe's dropout 0.1 / 0.1 on the trained
    weights (8 more each way, counted apart), and ``generate_ids(engine=
    "auto")`` of the trained model at B=8 x (10 + 246), which takes the wide
    kernel in sub-batches (``_wide_batch_cap``)."""
    import dataclasses

    from composer_tpu_torch.data import WindowDataset
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.ops import decode_kernel_wide as dw
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.train import generate as gen
    from composer_tpu_torch.train.trainer import Trainer

    config = TransformerConfig(**EMBED2048, dtype=torch.bfloat16, attention_dropout_rate=0.0,
                               residual_dropout_rate=0.0, use_pallas_attention=True)
    steps, batch, window = EMBED2048_TRAIN_STEPS, EMBED2048_BATCH, config.window_size
    events = batch * (window + 1) * (steps + 1)
    corpus = training_corpus(yaml_config, events)[:events]
    dataset = WindowDataset(corpus[:batch * (window + 1) * steps], batch, window, shuffle=True,
                            seed=0)
    if len(dataset) != steps:
        raise AssertionError(f"{len(dataset)} batches, wanted {steps}")
    model = Transformer(config)
    params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(model, ModelType.TRANSFORMER, learning_rate=1e-3, seed=0, device=device)
    state = trainer.init_state(batch, window)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        reset_flash_counts()
        state, step_seconds, losses, scalar = timed_train(trainer, state, dataset, tmp)
        launches = flash_counts(("mma", 128))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    mean_step = float(np.mean(step_seconds[1:]))
    print(f"embed-2048 train ({params:,} parameters): {len(losses)} steps, losses "
          f"{[round(x, 4) for x in losses]}, flash (bf16 tensor-core, head_dim 128) launches fwd "
          f"{launches[0]} bwd {launches[1]}; peak device memory {peak_gb:.2f} GiB", flush=True)
    print(f"embed-2048 train step time {mean_step * 1e3:.2f} ms (steps 2-{steps}, host clock "
          f"after synchronize; min {min(step_seconds[1:]) * 1e3:.2f}, max "
          f"{max(step_seconds[1:]) * 1e3:.2f}), {batch * window / mean_step:.1f} train events/s; "
          f"step 1 {step_seconds[0] * 1e3:.2f} ms; the trainer's events_per_second scalar "
          f"{scalar:.1f} [{card}]", flush=True)
    expected = (steps * config.num_layers,) * 2
    if launches != expected:
        raise AssertionError(f"embed-2048 flash launches {launches}, wanted {expected}")
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"bad embed-2048 losses: {losses}")
    profile_steps(trainer, state, dataset, card)

    # One step at dropout 0.1 / 0.1 on the trained weights: the in-kernel
    # dropout at head_dim 128.
    dropout_config = dataclasses.replace(config, attention_dropout_rate=0.1,
                                         residual_dropout_rate=0.1)
    dropout_trainer = Trainer(Transformer(dropout_config), ModelType.TRANSFORMER,
                              learning_rate=1e-3, seed=0, device=device)
    dropout_state = dropout_trainer.init_state(batch, window)
    dropout_state.model.load_state_dict(state.model.state_dict())
    x, y = next(iter(WindowDataset(corpus[-batch * (window + 1):], batch, window)))
    reset_flash_counts()
    dropout_loss = float(dropout_trainer.train_step(
        dropout_state, x, y, dropout_trainer.make_dropout_generator())["loss"])
    dropout_launches = flash_counts(("mma", 128))
    print(f"embed-2048 dropout 0.1 / 0.1 step: loss {dropout_loss:.4f}, flash launches fwd "
          f"{dropout_launches[0]} bwd {dropout_launches[1]}", flush=True)
    if dropout_launches != (config.num_layers,) * 2 or not np.isfinite(dropout_loss):
        raise AssertionError(f"embed-2048 dropout step: launches {dropout_launches}, loss "
                             f"{dropout_loss}")
    del dropout_trainer, dropout_state
    trained = state.model.eval()
    del trainer, state
    torch.cuda.empty_cache()

    # The trained model through generate_ids(auto): its weights outgrow the
    # L2, so the wide kernel, in sub-batches of what its shared memory admits.
    prompt = encoded_prompt(yaml_config, PROMPT_EVENTS)
    cache_len = gen._padded_cache_len(PROMPT_EVENTS + EMBED2048_GENERATE_EVENTS)
    sub_batch = gen._wide_batch_cap(config, cache_len)
    gen.generate_ids(trained, ModelType.TRANSFORMER, None, prompt, length=16, engine="auto")
    dw.decode_wide.launches = 0
    decode_generate.launches_batched = decode_generate.launches_single = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    ids = gen.generate_ids(trained, ModelType.TRANSFORMER, None, np.tile(prompt, (8, 1)),
                           length=EMBED2048_GENERATE_EVENTS, temperature=1.0, seed=5,
                           engine="auto")
    wall = time.perf_counter() - start
    wide, fused = dw.decode_wide.launches, (decode_generate.launches_batched
                                            + decode_generate.launches_single)
    print(f"embed-2048 generate_ids(auto) B=8 x ({PROMPT_EVENTS} + {EMBED2048_GENERATE_EVENTS}): "
          f"route decode_wide ({wide} launches, sub-batch {sub_batch} of 8 by the wide kernel's "
          f"shared memory), decode_generate launches {fused}; {wall:.3f} s, "
          f"{8 * EMBED2048_GENERATE_EVENTS / wall:.1f} events/s [{card}]", flush=True)
    if wide != -(-8 // sub_batch) or fused:
        raise AssertionError(f"embed-2048 generate: {wide} wide launches for sub-batch "
                             f"{sub_batch}, {fused} fused")
    if ids.shape != (8, PROMPT_EVENTS + EMBED2048_GENERATE_EVENTS) or ids.min() < 0 \
            or ids.max() >= config.vocab_size:
        raise AssertionError(f"embed-2048 generate: ids {ids.shape} outside the vocabulary")
    del trained
    gen._WIDE_ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    return {"launches": launches, "dropout_launches": dropout_launches,
            "step_ms": mean_step * 1e3, "sub_batch": sub_batch}


def wide_2048_vs_plain(device) -> float:
    """Phase 5c: the wide decode kernel against its plain version in
    float32 at the embed-2048 widths (16 heads of 128), cut to 2 layers for
    time, random weights from a numpy seed: 4 ragged rows (the most its
    shared memory admits in float32) x 150 steps at cache 256, greedy and
    sampled; identical ids, last-step logits within F32_LOGIT_TOL. Returns
    the largest logits error."""
    import dataclasses

    from composer_tpu_torch.models.convert import params_from_flax
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.ops import decode_kernel_wide as dw

    config = dataclasses.replace(TransformerConfig(**EMBED2048), num_layers=2)
    rows = 4
    if not dw.wide_kernel_fits(config, rows, WIDE_CHECK_CACHE, torch.float32):
        raise AssertionError("the wide kernel does not admit 4 float32 rows at embed 2048")
    model = Transformer(config)
    model.load_state_dict(params_from_flax(random_flax_params(config, seed=9), config))
    packed = dw.pack_weights_wide(model.state_dict(), config, dtype=torch.float32, device=device)
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, 390, (rows, 9)).astype(np.int32)
    plens = np.array([9, 3, 6, 1], np.int32)
    worst = 0.0
    for kind, sampling in (("greedy", (0.0, 0, 0.0)),
                           ("sampled", tuple(v[:rows] for v in WIDE_SAMPLED))):
        args = (packed, config, prompts, plens, sampling)
        ours, logits, _ = wide_run(*args, length=142, cache_len=WIDE_CHECK_CACHE)
        plain, plain_logits, _ = wide_run(*args, length=142, cache_len=WIDE_CHECK_CACHE,
                                          plain=True)
        err = float((logits - plain_logits).abs().max())
        print(f"wide embed-2048 (2 layers, head_dim 128) {kind} f32: ids "
              f"{'identical' if torch.equal(ours, plain) else 'DIFFER'} ({ours.shape[0]} x "
              f"{ours.shape[1]}, {len(set(ours.ravel().tolist()))} distinct), last-step logits "
              f"max_abs_err {err:.3e} (limit {F32_LOGIT_TOL})", flush=True)
        if not torch.equal(ours, plain) or err > F32_LOGIT_TOL:
            raise AssertionError(f"wide embed-2048 {kind}: kernel and plain version differ")
        worst = max(worst, err)
    return worst


def step_seconds_of(trainer, state, dataset, steps: int) -> list:
    """Host-clock seconds of ``steps`` train steps (each ends in a
    synchronize) on the windows of ``dataset``, with a dropout generator."""
    generator = trainer.make_dropout_generator()
    batches = iter(dataset)
    seconds = []
    for _ in range(steps):
        x, y = next(batches)
        torch.cuda.synchronize()
        start = time.perf_counter()
        trainer.train_step(state, x, y, generator)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    return seconds


def width_train_path(device, card: str, yaml_config, parent=None) -> dict:
    """Phase 5d: ``Trainer.train`` for ``WIDTH_TRAIN_STEPS`` steps through
    each flash kernel built that phases 5-5c do not train, each on the model
    whose attention has that shape (``use_pallas_attention``, relative
    attention, dropout 0.1 / 0.1): bf16 and float32 at head_dim 32 (embed
    512, 16 heads, batch 8 x 1024), float32 at 64 (the flagship with
    ``mixed_precision`` off, 8 x 2048) and at 128 (the embed-2048
    architecture in float32, 4 x 2048). Each float32 case is profiled
    (``profile_steps``: the flash share) and, with ``parent`` (another
    checkout's flash library), takes ``WIDTH_TRAIN_STEPS`` more steps on it
    and then on this one's, each timed apart. Returns the launches by
    ``(route, head_dim)`` and, under ``"step_ms"``, the float32 mean step
    times (steps 2-3: this, parent, this again)."""
    from composer_tpu_torch.data import WindowDataset
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.train.trainer import Trainer

    cases = (
        (("mma", 32), dict(vocab_size=390, embed_dim=512, window_size=1024, num_layers=8,
                           num_heads=16, use_relative_attention=True), torch.bfloat16, 8),
        (("tf32x3", 32), dict(vocab_size=390, embed_dim=512, window_size=1024, num_layers=8,
                              num_heads=16, use_relative_attention=True), torch.float32, 8),
        (("tf32x3", 64), FLAGSHIP, torch.float32, 8),
        (("tf32x3", 128), EMBED2048, torch.float32, EMBED2048_BATCH),
    )
    launched, step_ms = {}, {}
    for variant, widths, dtype, batch in cases:
        config = TransformerConfig(**widths, dtype=dtype, use_pallas_attention=True)
        if config.head_dim != variant[1]:
            raise AssertionError(f"{widths} has head_dim {config.head_dim}, not {variant[1]}")
        window, steps = config.window_size, WIDTH_TRAIN_STEPS
        events = batch * (window + 1) * steps
        dataset = WindowDataset(training_corpus(yaml_config, events)[:events], batch, window,
                                shuffle=True, seed=0)
        trainer = Trainer(Transformer(config), ModelType.TRANSFORMER, learning_rate=1e-3,
                          seed=0, device=device)
        state = trainer.init_state(batch, window)
        with tempfile.TemporaryDirectory() as tmp:
            reset_flash_counts()
            state, step_seconds, losses, _ = timed_train(trainer, state, dataset, tmp)
            launches = flash_counts(variant)
        mean_step = float(np.mean(step_seconds[1:]))
        print(f"train {str(dtype)[6:]} embed {config.embed_dim} (head_dim {variant[1]}) "
              f"{batch} x {window}: losses {[round(x, 4) for x in losses]}, flash "
              f"({variant[0]}, {variant[1]}) launches fwd {launches[0]} bwd {launches[1]}; step "
              f"time {mean_step * 1e3:.2f} ms (steps 2-{steps}), "
              f"{batch * window / mean_step:.1f} train events/s [{card}]", flush=True)
        if launches != (steps * config.num_layers,) * 2:
            raise AssertionError(f"{variant} launches {launches}, wanted "
                                 f"{steps * config.num_layers} each")
        if len(losses) != steps or not np.all(np.isfinite(losses)):
            raise AssertionError(f"bad {variant} losses: {losses}")
        launched[variant] = launches
        if dtype == torch.float32:
            profile_steps(trainer, state, dataset, card, steps)
            runs = {"this": mean_step * 1e3}
            if parent is not None:
                for name, lib in (("parent", parent), ("this again", None)):
                    fn = lambda: step_seconds_of(trainer, state, dataset, steps)
                    seconds = with_library("flash_attention", lib, fn) if lib else fn()
                    runs[name] = float(np.mean(seconds[1:])) * 1e3
            print(f"train float32 (head_dim {variant[1]}) step ms (steps 2-{steps}): "
                  + ", ".join(f"{name} {ms:.2f}" for name, ms in runs.items())
                  + f" [{card}]", flush=True)
            step_ms[variant] = runs
        del trainer, state
        torch.cuda.empty_cache()
    launched["step_ms"] = step_ms
    return launched


def profile_steps(trainer, state, dataset, card: str, steps: int = 3) -> None:
    """Device time by kernel over ``steps`` train steps (``torch.profiler``),
    against the host-clock window around them: the flash kernels' share of
    the step and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    generator = trainer.make_dropout_generator()
    batches = iter(dataset)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(state, *next(batches), generator)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash_ms = sum(e.self_device_time_total for e in kernels if "flash_" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    if total_ms <= 0:
        print("profiler: no device time recorded (not measured)", flush=True)
        return
    print(f"profile of {steps} train steps: window {window_ms:.2f} ms (host clock, profiler "
          f"on), device kernels {total_ms:.2f} ms, flash kernels {flash_ms:.2f} ms "
          f"({flash_ms / total_ms:.3f} of device time), device idle share "
          f"{1 - total_ms / window_ms:.3f} [{card}]", flush=True)
    print("  top kernels: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in top),
        flush=True)


def cuda_ms(fn, repeats: int) -> float:
    """Mean ms of ``fn`` over ``repeats`` calls after one warm-up, timed
    with CUDA events around the whole run."""
    fn()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    begin.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / repeats


def sdpa_backend(q, k, v):
    """The ``torch.nn.attention.SDPBackend`` that causal
    ``scaled_dot_product_attention`` takes on these tensors unpinned: the
    dispatcher's own choice (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True))


def flash_timings(device, card: str, dtype, shape, plain_repeats: int = 3,
                  parent=None) -> dict:
    """Kernel, plain version and SDPA (relative attention off only; a
    yardstick, not used by the port, pinned to the backend it takes
    unpinned, ``sdpa_backend``) at ``shape`` (B, H, S, D, W) in ``dtype``,
    for relative attention off and on and dropout 0 and 0.1. ``parent``:
    another checkout's flash library, whose kernels are timed before and
    after this one's (``parent_fwd``, ``parent_bwd``: the two runs)."""
    from torch.nn.attention import sdpa_kernel

    from composer_tpu_torch.ops import flash_attention as fa

    seed = torch.tensor([5], dtype=torch.int32, device=device)
    route = fa.kernel_variant(dtype, shape[3])
    result = {}
    for use_rel in (False, True):
        for rate in (0.0, 0.1):
            q, k, v, e, dout = flash_inputs(dtype, use_rel, device, seed=4, shape=shape)
            kw = dict(scale=True, dropout_rate=rate, dropout_seed=seed if rate else None)
            out, lse = fa.flash_attention_forward(q, k, v, e, **kw)
            directions = {
                "fwd": lambda: fa.flash_attention_forward(q, k, v, e, **kw),
                "bwd": lambda: fa.flash_attention_backward(q, k, v, e, out, lse, dout, **kw),
            }
            parent_times = []
            if parent is not None:
                parent_times.append({d: with_library("flash_attention", parent,
                                                     lambda: cuda_ms(fn, 20))
                                     for d, fn in directions.items()})
            times = {d: cuda_ms(fn, 20) for d, fn in directions.items()}
            times["plain_fwd"] = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, e, **kw),
                                         plain_repeats)
            times["plain_bwd"] = cuda_ms(lambda: fa.flash_attention_backward_reference(
                q, k, v, e, out, lse, dout, **kw), plain_repeats)
            if parent is not None:
                parent_times.append({d: with_library("flash_attention", parent,
                                                     lambda: cuda_ms(fn, 20))
                                     for d, fn in directions.items()})
                for d in directions:
                    times[f"parent_{d}"] = [run[d] for run in parent_times]
            for direction in ("fwd", "bwd"):
                ms, by = flash_bound(shape, use_rel, direction == "bwd", dtype)
                times[f"bound_{direction}"], times[f"bound_by_{direction}"] = ms, by
            if not use_rel and rate == 0.0:
                qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                backend = sdpa_backend(q, k, v)
                times["sdpa_backend"] = backend.name
                with sdpa_kernel([backend]):
                    times["sdpa_fwd"] = cuda_ms(lambda: sdpa(q, k, v, is_causal=True), 20)
                    times["sdpa_fwd_bwd"] = cuda_ms(lambda: torch.autograd.grad(
                        sdpa(qs, ks, vs, is_causal=True), (qs, ks, vs), dout), 20)
                    graph = sdpa(qs, ks, vs, is_causal=True)
                    times["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(
                        graph, (qs, ks, vs), dout, retain_graph=True), 20)
                del qs, ks, vs, graph
            result[(use_rel, rate)] = times
            print(f"flash {route} {str(dtype)[6:]} B,H,S,D,W={shape} rel={use_rel} "
                  f"dropout={rate}: " + ", ".join(
                      f"{name} {value:.4f} ms" if isinstance(value, float) else f"{name} {value}"
                      for name, value in times.items()) + f" [{card}]", flush=True)
            del q, k, v, e, dout, out, lse
    return result


def spec_check(name, packed, config, prompt, seed, sampling, block, length, cache_len):
    """One speculative generation through the kernel and its plain version on
    the same inputs; returns the largest |kernel - plain| over tokens and
    stats, which must be 0."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_spec as dks

    device = packed["wte"].device
    temps, topk, topp = dk.row_params(1, packed["wte"].shape[0], *sampling, False, True, True,
                                      "cpu")
    args = (packed, torch.as_tensor(prompt, dtype=torch.int32).to(device), seed,
            float(temps[0]), float(topk[0]), float(topp[0]))
    kwargs = dict(config=config, length=length, cache_len=cache_len, block=block)
    ours = dks.spec_decode(*args, **kwargs)
    plain = dks.speculative_generate_reference(*args, **kwargs)
    torch.cuda.synchronize()
    diff = max(int((a.long() - b.long()).abs().max()) for a, b in zip(ours, plain))
    blocks, gen_blocks, _ = ours[1].tolist()[:3]
    print(f"spec f32 {name}: tokens and stats identical={diff == 0}, blocks {blocks}, "
          f"generation blocks {gen_blocks}, acceptance {length / gen_blocks:.3f}, "
          f"distinct ids {len(set(plain[0].tolist()))}", flush=True)
    if diff:
        raise AssertionError(f"spec kernel and plain version disagree: {name}")
    return diff


def spec_vs_plain(device) -> int:
    """Phase 6a; returns the largest |kernel - plain| over tokens and stats."""
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.ops import decode_kernel as dk

    worst = 0
    rng = np.random.default_rng(12)
    greedy, sampled = (0.0, 0, 0.0), (1.0, 30, 0.9)
    for use_relative in (False, True):
        model, _ = build_model(use_relative, device)
        config = model.config
        packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32, device=device)
        prompt = rng.integers(0, 390, 10)
        # The plain version takes about 2 s a 64-step case: relative
        # attention is checked at the smallest and the largest block.
        for block in (2, 11) if use_relative else (2, 3, 5, 11):
            for seed, sampling in ((0, greedy), (5, sampled)):
                kind = "greedy" if sampling is greedy else "sampled"
                worst = max(worst, spec_check(f"rel={use_relative} T={block} {kind}", packed,
                                              config, prompt, seed, sampling, block, 64, 128))
        main = np.random.default_rng(2).integers(0, 390, PROMPT_EVENTS)
        main_cases = ((5, 0, greedy, "greedy"), (3, 11, (1.0, 0, 0.0), "sampled"))
        # The plain version takes 12 s a case at the main shape.
        for block, seed, sampling, kind in main_cases[use_relative:]:
            worst = max(worst, spec_check(
                f"rel={use_relative} T={block} {kind} main shape 1 x ({PROMPT_EVENTS} + "
                f"{GENERATE_EVENTS})", packed, config, main, seed, sampling, block,
                GENERATE_EVENTS, 1024))
    # Block 16 fits only narrower models (default widths: blocks <= 11).
    config = TransformerConfig(vocab_size=390, embed_dim=64, window_size=64, num_layers=2,
                               num_heads=4, use_relative_attention=True, initializer_stddev=0.3)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32, device=device)
    for seed, sampling in ((0, greedy), (5, sampled)):
        worst = max(worst, spec_check(f"E=64 T=16 seed {seed}", packed, config,
                                      rng.integers(0, 390, 10), seed, sampling, 16, 64, 128))
    return worst


def spec_sequential_case(name, packed, config, prompt, seed, sampling, block, length,
                         cache_len, runs=1) -> None:
    """The speculative kernel's ids against ``decode_generate``'s at batch 1
    on the same request: equal bit for bit, in either type (each emitted row
    is that kernel's step at its position, summed in its order). The
    speculative kernel runs ``runs`` times and must give the same ids each
    time (a race between the blocks of its cluster shows as ids that differ
    only sometimes)."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_spec as dks
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate

    device = packed["wte"].device
    temps, topk, topp = dk.row_params(1, packed["wte"].shape[0], *sampling, False, True, True,
                                      device)
    row = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    plens = torch.full((1,), len(prompt), dtype=torch.int32, device=device)
    sequential = decode_generate(packed, row[None], plens, seed, temps, topk, topp, None, None,
                                 config=config, num_steps=len(prompt) + length - 1,
                                 out_len=length, cache_len=cache_len, start_step=0)[0]
    args = (packed, row, seed, float(temps[0]), float(topk[0]), float(topp[0]))
    kwargs = dict(config=config, length=length, cache_len=cache_len, block=block)
    outs = [dks.spec_decode(*args, **kwargs)[0] for _ in range(runs)]
    same = [torch.equal(out, sequential) for out in outs]
    print(f"spec {name}: ids equal to decode_generate B=1 in {sum(same)} of {runs} run(s) "
          f"(G {dks.spec_decode.cluster} / {decode_generate.cluster})", flush=True)
    if not all(same):
        raise AssertionError(f"spec {name}: ids differ from the sequential kernel's")


def spec_vs_sequential(device) -> int:
    """Phase 6a': the speculative kernel's ids equal ``decode_generate``'s
    in float32 and bfloat16, relative attention off and on: greedy and
    sampled (top-k 30, top-p 0.9) at blocks 2, 3, 5 and 11, 64 steps with
    cache 128; greedy T=5 and sampled T=3 at the main path's shape, twice
    each. Returns the count of cases."""
    from composer_tpu_torch.ops import decode_kernel as dk

    cases = 0
    greedy, sampled = (0.0, 0, 0.0), (1.0, 30, 0.9)
    for use_relative in (False, True):
        model, _ = build_model(use_relative, device)
        config = model.config
        prompt = np.random.default_rng(12).integers(0, 390, 10)
        main = np.random.default_rng(2).integers(0, 390, PROMPT_EVENTS)
        for dtype in (torch.float32, torch.bfloat16):
            packed = dk.pack_weights(model.state_dict(), config, dtype=dtype, device=device)
            kind = f"{str(dtype)[6:]} rel={use_relative}"
            for block in (2, 3, 5, 11):
                for seed, sampling, how in ((0, greedy, "greedy"), (5, sampled, "sampled")):
                    spec_sequential_case(f"{kind} T={block} {how}", packed, config, prompt, seed,
                                         sampling, block, 64, 128)
                    cases += 1
            for block, seed, sampling, how in ((5, 0, greedy, "greedy"),
                                               (3, 11, sampled, "sampled")):
                spec_sequential_case(
                    f"{kind} T={block} {how} main shape 1 x ({PROMPT_EVENTS} + "
                    f"{GENERATE_EVENTS})", packed, config, main, seed, sampling, block,
                    GENERATE_EVENTS, 1024, runs=2)
                cases += 1
    return cases


def parent_libraries(checkout) -> dict:
    """``csrc/spec_decode.cu``, ``csrc/decode_wide.cu``,
    ``csrc/decode_wide_segment.cu`` and ``csrc/flash_attention.cu`` of
    ``checkout`` (the parent commit, unpacked with ``git archive``), each
    built with its own headers into ``build/parent_<name>/`` (one nvcc each,
    at once) and loaded with this checkout's argument types: their entry
    points keep their arguments (a larger zeroed scratch serves the parent's
    wide layout; the flash entry points' first integer still picks the
    route, 0 float32). Under ``"unchanged"``, the names whose source and
    included headers read as this checkout's: their timings are compared
    but not required to differ."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from composer_tpu_torch.ops import _build

    def build(name):
        source = Path(checkout).resolve() / "composer_tpu_torch" / "csrc" / f"{name}.cu"
        target = _build.BUILD_DIR.parent / f"parent_{name}" / f"lib{name}.so"
        target.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(source)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(target))
        for symbol, argtypes in _build.ENTRY_POINTS[name].items():
            getattr(lib, symbol).restype = ctypes.c_int
            getattr(lib, symbol).argtypes = argtypes
        return lib

    def source(csrc, name):
        texts, files = {}, [f"{name}.cu"]
        while files:
            file = files.pop()
            if file not in texts:
                texts[file] = (csrc / file).read_text()
                files += re.findall(r'#include "([^"]+)"', texts[file])
        return texts

    names = ("spec_decode", "decode_wide", "decode_wide_segment", "flash_attention")
    with ThreadPoolExecutor(len(names)) as pool:
        libraries = dict(zip(names, pool.map(build, names)))
    parent_csrc = Path(checkout).resolve() / "composer_tpu_torch" / "csrc"
    libraries["unchanged"] = {name for name in names
                              if source(parent_csrc, name) == source(_build.CSRC, name)}
    return libraries


def with_library(name: str, lib, fn):
    """``fn()`` with ``load_library(name)`` answering ``lib`` (another
    checkout's kernel, or a ``KernelSpans`` around one)."""
    from composer_tpu_torch.ops import _build

    load_library = _build.load_library
    _build.load_library = lambda n="decode_generate": lib if n == name else load_library(n)
    try:
        return fn()
    finally:
        _build.load_library = load_library


def spec_block_starts(prompt, tokens, block: int) -> list:
    """The start position of every verify block of a greedy speculative run,
    replayed on the host from its prompt and output: the drafts follow the
    kernel's rule, and a row matches when the true next token equals its
    draft. The run's last block may accept past the output; the replay stops
    extending it there (it is the last block either way)."""
    from composer_tpu_torch.ops.decode_kernel_spec import draft_inputs

    stream = np.concatenate([prompt, tokens]).astype(np.int64)
    plen, T = len(prompt), block
    ids = np.zeros(len(stream) + T + 1, np.int64)
    ids[:plen] = prompt
    starts, p0 = [], 0
    while p0 < len(stream) - 1:
        in_tok = draft_inputs(ids, p0, plen, T)
        ids[p0:p0 + T] = in_tok
        n = 1
        while n < T and p0 + n < len(stream) and (p0 + n < plen or stream[p0 + n] == in_tok[n]):
            n += 1
        if plen <= p0 + n < len(stream):
            ids[p0 + n] = stream[p0 + n]
        starts.append(p0)
        p0 += n
    return starts


def spec_bound(engine, prompt, tokens, blocks: int, block: int):
    """One speculative call: the packed weights, prompt, ids and stats moved
    once; per verified row (blocks x T, counted by replaying the run) the
    layer GEMVs and tied logits, attention over keys [0, position], and, as
    ``decode_bound`` counts them, its K/V row written in every layer and,
    once a block, the block's working set beyond the L2 (``kv_bytes``)."""
    config = engine.config
    E, L, W = config.embed_dim, config.num_layers, config.window_size
    starts = spec_block_starts(prompt, tokens, block)
    if len(starts) != blocks:
        raise AssertionError(f"replayed {len(starts)} blocks, the kernel ran {blocks}")
    weights = sum(t.numel() * t.element_size() for t in engine.packed.values())
    ids = (len(prompt) + len(tokens) + 8) * 4
    per_key = 6 if config.use_relative_attention else 4
    keys = sum(block * p0 + block * (block + 1) // 2 for p0 in starts)
    ends = np.asarray(starts, np.int64) + block
    flops = (blocks * block * (L * 24 * E * E + 2 * E * config.vocab_size)
             + L * per_key * E * keys)
    kv = kv_bytes(engine.packed, config, ends, np.minimum(ends, W), blocks * block)
    return bound(weights + ids + kv, flops)


def spec_bf16_check(name, packed, config, prompt, tokens) -> float:
    """A bf16 speculative run's tokens fed back through the plain version's
    bf16 forward (teacher-forced: both see the kernel's own prefix, so
    roundings cannot compound): every emitted token's logit must lie within
    BF16_LOGIT_REL_TOL x the logits' scale of its row's maximum. Returns
    the largest gap."""
    from composer_tpu_torch.ops.decode_kernel_spec import teacher_forced_logits

    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=packed["wte"].device)
    stream = np.concatenate([np.asarray(prompt), tokens.cpu().numpy()])
    rows = teacher_forced_logits(packed, stream, config=config)[len(prompt) - 1:-1]
    rows = rows[:, :config.vocab_size]
    scale = float(rows.abs().max())
    top = rows.max(-1)
    gap = float((top.values - rows[torch.arange(len(tokens)), tokens]).max())
    at_top = float((top.indices == tokens).float().mean())
    # How sharp the rule is: the ids per row that it would let through.
    admitted = float(((top.values[:, None] - rows) <= BF16_LOGIT_REL_TOL * scale)
                     .float().sum(-1).mean())
    print(f"spec bf16 {name}: teacher-forced, every emitted token within {gap:.3e} of its "
          f"row's max logit (limit {BF16_LOGIT_REL_TOL} x scale {scale:.3f}, which admits "
          f"{admitted:.2f} ids per row on average); tokens at the top of their row "
          f"{at_top:.4f}", flush=True)
    if not gap <= BF16_LOGIT_REL_TOL * scale:
        raise AssertionError(f"spec bf16 {name}: a token's logit is {gap} below its row's "
                             f"max > {BF16_LOGIT_REL_TOL} x {scale}")
    return gap


def spec_path(device, card: str, trained, parent=None) -> dict:
    """Phase 6b: batch-1 greedy generation through ``generate_ids(engine=
    "auto")``, which runs the speculative kernel, on random weights and on
    phase 5's restored model, against the sequential kernel on the same
    request (the ids must be equal); then the kernel, its plain version and
    the sequential kernel timed at the main path's shape, and, given
    ``parent`` (``parent_libraries``), another checkout's kernel on the
    same inputs in turns (parent, this, this, parent)."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.ops import _build
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_spec as dks
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.train import generate as gen

    model, config = build_model(False, device)
    prompt = encoded_prompt(config, PROMPT_EVENTS)

    def call(m, engine):
        torch.cuda.synchronize()
        start = time.perf_counter()
        ids = gen.generate_ids(m, ModelType.TRANSFORMER, None, prompt, length=GENERATE_EVENTS,
                               temperature=0.0, engine=engine)  # host ids: synchronized
        return ids, time.perf_counter() - start

    launches = 0
    for name, m in (("random weights", model), ("trained 20 steps, restored", trained)):
        call(m, "megakernel")  # packs the weights, warms both kernels up
        call(m, "auto")
        dks.spec_decode.launches = 0
        decode_generate.launches_single = decode_generate.launches_batched = 0
        spec_ids, spec_s = call(m, "auto")
        counts = (dks.spec_decode.launches, decode_generate.launches_single,
                  decode_generate.launches_batched)
        stats = gen.LAST_SPEC_STATS
        launches += counts[0]
        seq_ids, seq_s = call(m, "megakernel")
        spec_ids2, spec_s2 = call(m, "auto")
        seq_ids2, seq_s2 = call(m, "megakernel")
        print(f"spec {name}: launches spec {counts[0]}, sequential B=1 {counts[1]}, "
              f"batched {counts[2]}; stats {stats[:3].tolist()}, acceptance "
              f"{GENERATE_EVENTS / stats[1]:.3f} tokens per generation block", flush=True)
        if counts != (1, 0, 0):
            raise AssertionError(f"greedy batch-1 auto did not run the spec kernel: {counts}")
        generated = spec_ids[PROMPT_EVENTS:]
        if spec_ids.shape != (PROMPT_EVENTS + GENERATE_EVENTS,) or generated.min() < 0 \
                or generated.max() >= 390 or not np.array_equal(spec_ids, spec_ids2):
            raise AssertionError(f"spec {name}: bad ids {spec_ids.shape}")
        engine = gen._packed_engine(m, None)
        spec_bf16_check(f"{name}, generate_ids", engine.packed, engine.config,
                        spec_ids[:PROMPT_EVENTS], generated)
        with tempfile.TemporaryDirectory() as tmp:
            size = write_midi(spec_ids, config, Path(tmp) / "spec.mid")
        if size <= 0:
            raise AssertionError("the MIDI file is empty")
        agree = float((generated == seq_ids[PROMPT_EVENTS:]).mean())
        first = int(np.argmax(generated != seq_ids[PROMPT_EVENTS:])) if agree < 1 else None
        print(f"spec {name}: bf16 ids agreement with the sequential kernel {agree:.4f} "
              f"(first difference at {first}); {len(set(generated.tolist()))} distinct; "
              f"MIDI {size} bytes", flush=True)
        if agree != 1.0:
            raise AssertionError(f"spec {name}: ids differ from the sequential kernel's at "
                                 f"{first}")
        print(f"spec {name}: generate_ids B=1 x {GENERATE_EVENTS} greedy, host clock: spec "
              f"{spec_s:.4f} / {spec_s2:.4f} s ({GENERATE_EVENTS / spec_s:.1f} / "
              f"{GENERATE_EVENTS / spec_s2:.1f} events/s), sequential {seq_s:.4f} / "
              f"{seq_s2:.4f} s ({GENERATE_EVENTS / seq_s:.1f} / {GENERATE_EVENTS / seq_s2:.1f}"
              f" events/s); speed-up {seq_s / spec_s:.3f} / {seq_s2 / spec_s2:.3f} [{card}]",
              flush=True)

    # The kernel alone at the main path's shape, random weights, bf16.
    engine = gen._packed_engine(model, None)
    packed, block = engine.packed, dks.default_block(True)
    row = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    args = (packed, row, 0, 0.0, 513.0, 2.0)
    kwargs = dict(config=engine.config, length=GENERATE_EVENTS, cache_len=1024, block=block)
    tokens, stats = dks.spec_decode(*args, **kwargs)
    spec_bf16_check(f"kernel T={block}, random weights", packed, engine.config, prompt,
                    tokens.cpu().numpy())

    def parent_ms():
        lib = parent["spec_decode"]
        ms = with_library("spec_decode", lib,
                          lambda: cuda_ms(lambda: dks.spec_decode(*args, **kwargs), 3))
        parent_tokens = with_library("spec_decode", lib,
                                     lambda: dks.spec_decode(*args, **kwargs)[0])
        return ms, float((parent_tokens == tokens).float().mean())

    parent_times = [parent_ms()] if parent is not None else []
    spec_ms = cuda_ms(lambda: dks.spec_decode(*args, **kwargs), 3)
    cluster = dks.spec_decode.cluster
    spec_ms2 = cuda_ms(lambda: dks.spec_decode(*args, **kwargs), 3)
    if parent is not None:
        parent_times.append(parent_ms())
    temps, topk, topp = dk.row_params(1, 512, 0.0, 0, 0.0, True, False, False, device)
    plens = torch.full((1,), PROMPT_EVENTS, dtype=torch.int32, device=device)
    seq_ms = cuda_ms(lambda: decode_generate(
        packed, row[None], plens, 0, temps, topk, topp, None, None, config=engine.config,
        num_steps=PROMPT_EVENTS + GENERATE_EVENTS - 1, out_len=GENERATE_EVENTS,
        cache_len=1024, start_step=0), 3)
    torch.cuda.synchronize()
    start = time.perf_counter()
    plain_tokens, _ = dks.speculative_generate_reference(*args, **kwargs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - start) * 1e3
    blocks = int(stats[0])
    bound_ms, bound_by = spec_bound(engine, prompt, tokens.cpu().numpy(), blocks, block)
    steps = PROMPT_EVENTS + GENERATE_EVENTS - 1
    ratio = spec_ms / blocks / (seq_ms / steps)
    print(f"spec kernel B=1 x {GENERATE_EVENTS} bf16 greedy T={block}, cluster G {cluster}: "
          f"{spec_ms:.2f} / {spec_ms2:.2f} ms, {blocks} blocks ({spec_ms / blocks * 1e3:.1f} us "
          f"per block); sequential kernel {seq_ms:.2f} ms ({seq_ms / steps * 1e3:.1f} us per "
          f"step); block / step {ratio:.3f}, the break-even acceptance (this content's: "
          f"{GENERATE_EVENTS / int(stats[1]):.3f}); plain version {plain_ms:.2f} ms (ids "
          f"agreement {float((plain_tokens == tokens).float().mean()):.4f}); bound "
          f"{bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
    clock = torch.zeros(len(dks.PHASES), dtype=torch.int64, device=device)
    dks.spec_decode(*args, **kwargs, phase_ns=clock)
    clock_ms = clock.double().cpu().numpy() / 1e6
    print(f"spec kernel T={block} by phase (rank 0's clock, {blocks} verify blocks): " + ", ".join(
        f"{name} {ms:.2f} ms ({ms / clock_ms.sum():.3f})" for name, ms in zip(dks.PHASES, clock_ms))
        + f"; {clock_ms.sum():.2f} ms in all [{card}]", flush=True)
    if parent is not None:
        print("spec kernel, the parent checkout's kernel on the same inputs "
              f"(parent, this, this, parent): {parent_times[0][0]:.2f}, {spec_ms:.2f}, "
              f"{spec_ms2:.2f}, {parent_times[1][0]:.2f} ms; the parent's ids agree with "
              f"this kernel's {parent_times[0][1]:.4f} "
              f"[{card}]", flush=True)
    else:
        print("spec kernel, parent: not measured (no --parent checkout given)", flush=True)
    return {"launches": launches, "ms": spec_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "cluster": cluster,
            "parent_ms": [t[0] for t in parent_times] or None}


SEGMENT_STEPS = 64  # the JAX `serve` defaults: composer_tpu/cli.py:634-649
SERVE_SLOTS, SERVE_CACHE = 8, 2048


def segment_stream(packed, config, prompts, plens, starts, boundaries, sampling, *,
                   cache_len, plain=False, live=None, seed=3):
    """One run over the segments ``boundaries`` on fresh state, by the kernel
    (``decode_segment``) or its plain version: ``(stream (B, steps), carry)``
    on the host. ``live=None`` grows it as the service does: the oldest
    row's reach rounded up to 256."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_segmented as seg

    device = packed["wte"].device
    rows = dk.row_params(len(prompts), packed["wte"].shape[0], *sampling,
                         *dk.sampling_flags(*sampling), device)
    host = [torch.as_tensor(t, dtype=torch.int32, device=device) for t in (prompts, plens, starts)]
    state = seg.init_segment_state(packed, config, len(prompts), cache_len)
    active = starts != seg.PARKED
    chunks = []
    for b0, b1 in zip(boundaries[:-1], boundaries[1:]):
        reach = int((b1 - starts[active]).max())
        kwargs = dict(config=config, steps=b1 - b0, cache_len=cache_len,
                      live=live or min(cache_len, -(-reach // 256) * 256))
        if plain:
            tokens, *state = seg.decode_segment_reference(packed, *state, *host, b0, seed, *rows,
                                                          **kwargs)
        else:
            tokens, *state = seg.decode_segment(packed, *state, prompts, plens, starts, b0, seed,
                                                *sampling, **kwargs)
        chunks.append(tokens)
    torch.cuda.synchronize()
    return torch.cat(chunks, dim=1).cpu(), state[2].cpu()


def segment_vs_plain(device) -> int:
    """Phase 7a; returns the largest |kernel - plain| over ids and carry."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_segmented as seg
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate

    worst = 0
    greedy = (0.0, 0, 0.0)
    sampled = (np.array([1.0, 0.8, 0.0, 1.2, 1.0, 0.7, 1.0, 1.0], np.float32),
               np.array([0, 20, 0, 5, 0, 40, 0, 3]),
               np.array([0.9, 0.0, 0.0, 0.8, 0.0, 0.95, 0.0, 0.0], np.float32))

    def compare(name, ours, plain):
        nonlocal worst
        diff = max(int((a.long() - b.long()).abs().max()) for a, b in zip(ours, plain))
        worst = max(worst, diff)
        print(f"segment f32 {name}: ids and carry identical={diff == 0}, distinct ids "
              f"{len(set(plain[0].flatten().tolist()))}", flush=True)
        if diff:
            raise AssertionError(f"segment kernel and plain version disagree: {name}")

    rng = np.random.default_rng(13)
    for use_relative in (False, True):
        model, _ = build_model(use_relative, device)
        config = model.config
        packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32, device=device)
        prompts = rng.integers(0, 390, (8, 10)).astype(np.int32)
        plens = np.array([10, 4, 7, 1, 10, 6, 9, 2], np.int32)
        # Slot 4 arrives at step 3, slot 7 at step 40, slot 6 stays parked.
        starts = np.array([0, 0, 0, 0, 3, 0, seg.PARKED, 40], np.int32)
        for kind, sampling in (("greedy", greedy), ("sampled", sampled)):
            streams = []
            for length in (1, 7, 64):
                boundaries = list(range(0, 64, length)) + [64]
                runs = [segment_stream(packed, config, prompts, plens, starts, boundaries,
                                       sampling, cache_len=128, live=128, plain=plain)
                        for plain in (False, True)]
                compare(f"rel={use_relative} {kind} segments of {length}", *runs)
                streams.append(runs[0][0])
            if not all(torch.equal(streams[0], other) for other in streams[1:]):
                raise AssertionError(f"segmentations disagree: rel={use_relative} {kind}")
            if (streams[0][6] != -1).any() or (streams[0][7, :40] != -1).any():
                raise AssertionError("a parked slot emitted a token")

    # The service's shape: 8 x (10 + 1014) in 16 segments of 64, cache 2048,
    # against the plain version and against decode_generate (one launch;
    # with every row started at step 0 both draw the same Philox bits).
    main = np.random.default_rng(2).integers(0, 390, (8, PROMPT_EVENTS)).astype(np.int32)
    plens = np.full(8, PROMPT_EVENTS, np.int32)
    starts = np.zeros(8, np.int32)
    boundaries = list(range(0, 16 * SEGMENT_STEPS + 1, SEGMENT_STEPS))
    for use_relative, kind, sampling, seed in ((False, "greedy", greedy, 0),
                                               (True, "sampled", sampled, 11)):
        model, _ = build_model(use_relative, device)
        config = model.config
        packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32, device=device)
        # The plain version takes about 1 s a segment here: it runs for the
        # first case; both cases are held to one decode_generate launch.
        runs = [segment_stream(packed, config, main, plens, starts, boundaries, sampling,
                               cache_len=SERVE_CACHE, plain=plain, seed=seed)
                for plain in ((False, True) if not use_relative else (False,))]
        if len(runs) == 2:
            compare(f"rel={use_relative} {kind} 8 x ({PROMPT_EVENTS} + {GENERATE_EVENTS}), "
                    f"cache {SERVE_CACHE}, segments of {SEGMENT_STEPS}", *runs)
        temps, topk, topp = dk.row_params(8, 512, *sampling, *dk.sampling_flags(*sampling),
                                          device)
        fused = decode_generate(packed, torch.as_tensor(main, device=device),
                                torch.as_tensor(plens, device=device), seed, temps, topk, topp,
                                None, None, config=config,
                                num_steps=PROMPT_EVENTS + GENERATE_EVENTS - 1,
                                out_len=GENERATE_EVENTS, cache_len=SERVE_CACHE, start_step=0)
        generated = runs[0][0][:, PROMPT_EVENTS - 1:PROMPT_EVENTS - 1 + GENERATE_EVENTS]
        same = torch.equal(generated, fused.cpu())
        print(f"segment f32 rel={use_relative} {kind}: ids equal decode_generate's={same}",
              flush=True)
        if not same:
            raise AssertionError(f"segment kernel and decode_generate disagree: {kind}")
    return worst


def segment_bound(packed, config, starts, step0: int, steps: int, live: int):
    """One segment: the packed weights, the prompts, per-row inputs and ids
    moved once; per step and active row its K/V row written (while pos <
    live) in every layer, and the step's working set beyond the L2: the
    weights, the K/V prefixes [0, min(pos, live-1)] of the active rows and
    the band rows they reach (``kv_bytes``); per step and active row the
    layer GEMVs, the tied logits and attention over its keys."""
    E, L, W = config.embed_dim, config.num_layers, config.window_size
    weights = sum(t.numel() * t.element_size() for t in packed.values())
    per_key = 6 if config.use_relative_attention else 4
    flops, prefix_rows, band_rows, written = 0, [], [], 0
    for i in range(step0, step0 + steps):
        pos = i - starts[starts != 2**30].astype(np.int64)
        pos = pos[pos >= 0]
        if not len(pos):
            continue
        keys = np.minimum(pos, live - 1) + 1
        prefix_rows.append(int(keys.sum()))
        band_rows.append(min(int(keys.max()), W))
        written += int((pos < live).sum())
        flops += len(pos) * (L * 24 * E * E + 2 * E * config.vocab_size)
        flops += L * per_key * E * int(keys.sum())
    kv = kv_bytes(packed, config, prefix_rows, band_rows, written)
    ids = len(starts) * (PROMPT_EVENTS + steps + 8) * 4
    return bound(weights + ids + kv, flops)


def segment_timings(device, card: str) -> dict:
    """Phase 7b: the kernel at the service's shape in bf16 (8 rows x (10 +
    1014) in 16 segments of 64, cache 2048, greedy), per segment, against
    the plain version and against one decode_generate launch for the same
    generation (the cost of segmenting)."""
    from composer_tpu_torch.ops import _build
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.ops.decode_kernel_segmented import decode_segment

    model, _ = build_model(False, device)
    config = model.config
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.bfloat16, device=device)
    prompts = np.random.default_rng(3).integers(0, 390, (8, PROMPT_EVENTS)).astype(np.int32)
    plens = np.full(8, PROMPT_EVENTS, np.int32)
    starts = np.zeros(8, np.int32)
    greedy = (0.0, 0, 0.0)
    boundaries = list(range(0, 16 * SEGMENT_STEPS + 1, SEGMENT_STEPS))
    args = (packed, config, prompts, plens, starts, boundaries, greedy)
    segment_stream(*args, cache_len=SERVE_CACHE)  # warm-up
    spans = KernelSpans(_build.load_library("decode_segment"))
    load_library = _build.load_library
    _build.load_library = lambda name="decode_segment": spans
    try:
        ours, _ = segment_stream(*args, cache_len=SERVE_CACHE)
        ours, _ = segment_stream(*args, cache_len=SERVE_CACHE)
    finally:
        _build.load_library = load_library
    torch.cuda.synchronize()
    per_segment = [begin.elapsed_time(end) for begin, end in spans.spans]
    kernel_ms = float(np.mean(per_segment))
    cluster = decode_segment.cluster
    start = time.perf_counter()
    plain, _ = segment_stream(*args, cache_len=SERVE_CACHE, plain=True)
    plain_ms = (time.perf_counter() - start) * 1e3 / 16
    temps, topk, topp = dk.row_params(8, 512, *greedy, True, False, False, device)
    fused_args = (packed, torch.as_tensor(prompts, device=device),
                  torch.as_tensor(plens, device=device), 0, temps, topk, topp, None, None)
    fused_kwargs = dict(config=config, num_steps=PROMPT_EVENTS + GENERATE_EVENTS - 1,
                        out_len=GENERATE_EVENTS, cache_len=SERVE_CACHE, start_step=0)
    fused = decode_generate(*fused_args, **fused_kwargs).cpu()
    fused_ms = cuda_ms(lambda: decode_generate(*fused_args, **fused_kwargs), 3)
    generated = ours[:, PROMPT_EVENTS - 1:PROMPT_EVENTS - 1 + GENERATE_EVENTS]
    agree = float((generated == fused).float().mean())
    agree_plain = float((ours == plain).float().mean())
    bounds = [segment_bound(packed, config, starts, b0, SEGMENT_STEPS,
                            min(SERVE_CACHE, -(-(b0 + SEGMENT_STEPS) // 256) * 256))
              for b0 in boundaries[:-1]]
    bound_ms = float(np.mean([ms for ms, _ in bounds]))
    bound_by = bounds[-1][1]
    half = len(per_segment) // 2
    print(f"segment kernel bf16, 8 live rows x {SEGMENT_STEPS} steps, cache {SERVE_CACHE}: "
          f"{kernel_ms:.3f} ms per segment (mean of {len(per_segment)} over two runs; first "
          f"segment {per_segment[half]:.3f} ms, last {per_segment[-1]:.3f} ms; "
          f"{kernel_ms / SEGMENT_STEPS * 1e3:.1f} us per step; cluster size {cluster}); "
          f"plain version "
          f"{plain_ms:.2f} ms per segment (ids agreement {agree_plain:.4f}); bound "
          f"{bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
    print(f"8 x {GENERATE_EVENTS} bf16 greedy: 16 segments {16 * kernel_ms:.2f} ms against one "
          f"decode_generate launch {fused_ms:.2f} ms (cost of segmenting "
          f"{16 * kernel_ms / fused_ms:.4f}x); ids agreement with decode_generate {agree:.4f} "
          f"[{card}]", flush=True)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "fused_ms": fused_ms, "agree": agree, "cluster": cluster}


def gumbel_rows(seed: int, slot: int, steps, vpad: int, device):
    """The kernels' Gumbel noise for one slot at several global steps: row t
    is ``ops/decode_kernel.py::gumbel_noise(seed, ., steps[t], vpad)[slot]``."""
    from composer_tpu_torch.ops.philox import MASK32, philox4x32_10

    steps = torch.as_tensor(np.asarray(steps), dtype=torch.int64, device=device)
    groups = vpad // 4
    c0 = torch.arange(groups, dtype=torch.int64, device=device)[None].expand(len(steps), groups)
    c1 = (steps[:, None] & MASK32).expand(-1, groups)
    words = philox4x32_10(c0, c1, torch.full_like(c0, slot), torch.zeros_like(c0), seed)
    bits = torch.stack(words, dim=-1).reshape(len(steps), vpad)
    uniform = (bits >> 9).to(torch.float32) * (1.0 / (1 << 23)) + 1e-12
    return -torch.log(-torch.log(uniform))


def sampled_token_gap(scaled, noise, tokens, top_k, top_p, delta: float) -> float:
    """How far each emitted token falls short of what a kernel could have
    sampled if each of its scaled logits may differ from ``scaled`` (the
    plain version's, teacher-forced) by up to ``delta / 2``. Lane i may be
    kept by the kernel's top-k / top-p (the fused kernels' definition: both
    filters on the unfiltered row) when the lanes surely above it (more
    than ``delta`` above) number fewer than k and, with their logits lowered
    and the others raised by ``delta / 2``, hold less than p of the mass; it
    is surely kept when the same holds for every lane within ``delta`` of
    it raised and the others lowered. Returns inf when a token could not
    have been kept, else the largest excess of the best surely kept lane's
    noisy score over the token's, which must stay within ``delta``."""
    x = scaled.double()
    steps, vocab = x.shape
    ascending = torch.sort(x, dim=-1).values
    e = torch.exp(ascending - ascending[:, -1:])
    suffix = torch.cat([e.flip(-1).cumsum(-1).flip(-1), e.new_zeros(steps, 1)], dim=-1)
    total = suffix[:, :1]
    lane = torch.exp(x - ascending[:, -1:])

    def above(threshold):  # count and mass of the lanes scoring above threshold
        index = torch.searchsorted(ascending, threshold.contiguous(), right=True)
        return vocab - index, torch.gather(suffix, -1, index)

    shift = np.exp(delta / 2)
    count, mass = above(x + delta)
    possible = torch.ones_like(x, dtype=torch.bool)
    count_in, mass_in = above(x - delta)
    if delta > 0:  # lane i itself lies above x_i - delta, but not above itself
        count_in, mass_in = count_in - 1, mass_in - lane
    sure = torch.ones_like(possible)
    if top_k > 0:
        possible &= count < top_k
        sure &= count_in < top_k
    if 0 < top_p < 1:
        low = mass / shift
        possible &= low / (low + (total - mass) * shift) < top_p
        high = mass_in * shift
        sure &= high / (high + (total - mass_in) / shift) < top_p
    rows = torch.arange(steps, device=x.device)
    if not bool(possible[rows, tokens].all()):
        return float("inf")
    score = scaled + noise
    best = torch.where(sure, score, -np.inf).max(-1).values
    return float((best - score[rows, tokens]).max())


def serve_path(device, card: str) -> dict:
    """Phase 7c: ``ContinuousGenerationService`` with the JAX `serve`
    defaults (8 slots, segments of 64, cache 2048, bf16) on the card: 16
    requests of 10 + 1014 events from 16 threads at once, 8 greedy and 8
    sampled, so half wait for a slot and join the running batch."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.ops import _build
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_segmented as seg
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.ops.decode_kernel_spec import teacher_forced_logits
    from composer_tpu_torch.serving import ContinuousGenerationService

    model, yaml_config = build_model(False, device)
    config = model.config
    rng = np.random.default_rng(21)
    prompts = [encoded_prompt(yaml_config, PROMPT_EVENTS)] + [
        rng.integers(0, 390, PROMPT_EVENTS).astype(np.int32) for _ in range(15)]
    sampling = [(0.0, 0, 0.0)] * 8 + [(1.0, k, p) for k, p in (
        (0, 0.0), (40, 0.0), (0, 0.9), (20, 0.95), (5, 0.0), (0, 0.8), (100, 0.9), (0, 0.0))]
    service = ContinuousGenerationService(model, ModelType.TRANSFORMER, None, 390)
    results, admitted = [None] * 16, {}
    spans = KernelSpans(_build.load_library("decode_segment"))
    load_library = _build.load_library
    try:
        packed = service.packed
        if (service.slots, service.seg_steps, service.cache_len, service.capacity) != (
                SERVE_SLOTS, SEGMENT_STEPS, SERVE_CACHE, SERVE_CACHE) \
                or packed["wte"].dtype != torch.bfloat16 or packed["wte"].device != device:
            raise AssertionError("the service did not take the serve defaults on the card")
        service.submit(prompts[1], 64, temperature=0.0, deadline_ms=300_000)  # warm-up
        admit = service._admit

        def record(request, slot):
            admit(request, slot)
            admitted[request.prompt_ids.tobytes()] = (slot, int(service._starts[slot]))

        service._admit = record
        _build.load_library = lambda name="decode_segment": spans
        segments_before = len(service.batch_sizes)

        def call(i):
            temperature, top_k, top_p = sampling[i]
            results[i] = service.submit(prompts[i], GENERATE_EVENTS, temperature=temperature,
                                        top_k=top_k, top_p=top_p, deadline_ms=600_000)

        threads = [threading.Thread(target=call, args=(i,), daemon=True) for i in range(16)]
        seg.decode_segment.launches = 0
        start = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=600)
        wall = time.perf_counter() - start
        launches = seg.decode_segment.launches
        stats = service.overload_stats()
        batch_sizes = service.batch_sizes[segments_before:]
    finally:
        _build.load_library = load_library
        service.close()
    busy_ms = spans.ms()
    window_ms = spans.spans[0][0].elapsed_time(spans.spans[-1][1])
    if any(r is None for r in results):
        raise AssertionError("a request of the burst did not complete")
    print(f"serve burst: 16 x ({PROMPT_EVENTS} + {GENERATE_EVENTS}) from 16 threads in "
          f"{wall:.3f} s (host clock), {16 * GENERATE_EVENTS / wall:.1f} events/s; {launches} "
          f"segment launches; device busy share {busy_ms / window_ms:.5f} (CUDA events around "
          f"each segment: {busy_ms:.2f} ms of a {window_ms:.2f} ms device window, which ends "
          f"with the segment still in flight after the last response); latency p50 "
          f"{stats['latency_p50_s']:.3f} s, p95 {stats['latency_p95_s']:.3f} s; active rows "
          f"per segment {batch_sizes} [{card}]", flush=True)
    if launches < 1:
        raise AssertionError("the service did not launch the segment kernel")
    slot_starts = sorted(step for _, step in admitted.values())
    if sum(step > slot_starts[0] for step in slot_starts) < 8:
        raise AssertionError(f"fewer than 8 requests joined a running batch: {slot_starts}")

    worst = 0.0
    for i, ids in enumerate(results):
        if ids.shape != (PROMPT_EVENTS + GENERATE_EVENTS,) or ids.min() < 0 or ids.max() >= 390 \
                or not np.array_equal(ids[:PROMPT_EVENTS], prompts[i]):
            raise AssertionError(f"request {i}: bad response {ids.shape}")
        # Teacher-forced through the plain bf16 forward: row p scores the
        # token after position p; a sampled row adds the kernel's noise of
        # (seed, slot, global step) to its filtered, scaled logits.
        logits = teacher_forced_logits(packed, ids, config=config)[PROMPT_EVENTS - 1:-1]
        temperature, top_k, top_p = sampling[i]
        scaled, noise = logits, torch.zeros_like(logits)
        if temperature > 0:
            slot, start_step = admitted[prompts[i].tobytes()]
            steps = start_step + PROMPT_EVENTS - 1 + np.arange(GENERATE_EVENTS)
            scaled = logits / temperature
            noise = gumbel_rows(service._seed, slot, steps, packed["wte"].shape[0], device)
        scale = float(scaled[:, :390].abs().max())
        tokens = torch.as_tensor(ids[PROMPT_EVENTS:], dtype=torch.long, device=device)
        gap = sampled_token_gap(scaled[:, :390], noise[:, :390], tokens, top_k, top_p,
                                BF16_LOGIT_REL_TOL * scale)
        worst = max(worst, gap)
        if not gap <= BF16_LOGIT_REL_TOL * scale:
            raise AssertionError(f"request {i}: a token scores {gap} below its row's max > "
                                 f"{BF16_LOGIT_REL_TOL} x {scale}")
    greedy = np.stack(prompts[:8])
    temps, topk, topp = dk.row_params(8, 512, 0.0, 0, 0.0, True, False, False, device)
    fused = decode_generate(packed, torch.as_tensor(greedy, device=device),
                            torch.full((8,), PROMPT_EVENTS, dtype=torch.int32, device=device), 0,
                            temps, topk, topp, None, None, config=config,
                            num_steps=PROMPT_EVENTS + GENERATE_EVENTS - 1,
                            out_len=GENERATE_EVENTS, cache_len=SERVE_CACHE,
                            start_step=0).cpu().numpy()
    agree = float((np.stack(results[:8])[:, PROMPT_EVENTS:] == fused).mean())
    print(f"serve burst: every token of the 16 responses, teacher-forced through the plain "
          f"bf16 forward, could have been kept and scores within {worst:.3e} of the best lane "
          f"surely kept (limit {BF16_LOGIT_REL_TOL} x scale); slot starts {slot_starts}; "
          f"greedy responses' agreement with decode_generate "
          f"{agree:.4f}", flush=True)
    return {"launches": launches, "agree": agree}


FLAGSHIP = dict(vocab_size=390, embed_dim=1024, window_size=2048, num_layers=8, num_heads=16,
                use_relative_attention=True)  # docs/validation.md:148-170
WIDE_CHECK_CACHE = 256  # 150 steps: past the int8 K/V window at 128
WIDE_SAMPLED = (np.array([1.0, 0.8, 0.0, 1.2, 1.0, 0.7, 1.0, 1.0], np.float32),
                np.array([0, 20, 0, 5, 0, 40, 0, 3]),
                np.array([0.9, 0.0, 0.0, 0.8, 0.0, 0.95, 0.0, 0.0], np.float32))


def build_flagship(device):
    """The embed-1024 flagship (the best-NLL model of the TPU rounds) with
    random weights from a numpy seed."""
    from composer_tpu_torch.models.convert import params_from_flax
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig

    config = TransformerConfig(**FLAGSHIP)
    model = Transformer(config)
    model.load_state_dict(params_from_flax(random_flax_params(config, seed=8), config))
    return model.to(device).eval()


def wide_run(packed, config, prompts, plens, sampling, *, length, cache_len, plain=False,
             quantize_kv=False, state=None, seed=3, phase_ns=None):
    """One generation by the wide kernel (``phase_ns``: its clock) or its
    plain version: (ids on the host, last-step logits, K/V state)."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_wide as dw

    device = packed["wte"].device
    batch, width = prompts.shape
    vpad = packed["wte"].shape[0]
    rows = dk.row_params(batch, vpad, *sampling, *dk.sampling_flags(*sampling), device)
    if state is None:
        state = dw.init_kv_state(config, batch, cache_len, packed["wte"].dtype, quantize_kv,
                                 device)
    logits = torch.zeros((batch, vpad), device=device)
    num_steps = width + length - 1
    args = (packed, state, torch.as_tensor(prompts, dtype=torch.int32, device=device),
            torch.as_tensor(plens, dtype=torch.int32, device=device), seed, *rows)
    kwargs = dict(config=config, num_steps=num_steps, out_len=num_steps, cache_len=cache_len,
                  logits_out=logits)
    if plain:
        ids = dw.decode_wide_reference(*args, **kwargs)
    else:
        ids = dw.decode_wide(*args, **kwargs, phase_ns=phase_ns)
    torch.cuda.synchronize()
    return ids.cpu(), logits, state


def wide_teacher_forced_gap(packed, config, prompts, plens, sampling, ids, *, cache_len,
                           quantize_kv=False, seed=3) -> float:
    """The bf16 rule for a wide run's ids ``(B, num_steps)`` (``wide_run``):
    each row's stream, teacher-forced through the plain version, must score
    every emitted token within 2% of the logits' scale of a token the kernel
    could have sampled (``sampled_token_gap``, with the kernel's Philox noise
    of (seed, row, step) on a sampled row). Returns the largest gap over
    its row's scale."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_wide as dw

    device = packed["wte"].device
    vpad, vocab = packed["wte"].shape[0], config.vocab_size
    batch, num_steps = ids.shape
    streams = np.zeros((batch, num_steps + 1), np.int32)
    for b, plen in enumerate(plens):
        streams[b, :plen] = prompts[b, :plen]
        streams[b, plen:] = ids[b, :num_steps + 1 - plen].numpy()
    temps, topks, topps = (np.broadcast_to(np.asarray(v), (batch,)) for v in sampling)
    rows = dk.row_params(batch, vpad, *sampling, *dk.sampling_flags(*sampling), device)
    logits = torch.zeros((batch, num_steps, vpad), device=device)
    dw.decode_wide_reference(
        packed, dw.init_kv_state(config, batch, cache_len, packed["wte"].dtype, quantize_kv,
                                 device),
        torch.as_tensor(streams, device=device),
        torch.full((batch,), num_steps + 1, dtype=torch.int32, device=device), seed, *rows,
        config=config, num_steps=num_steps, out_len=1, cache_len=cache_len,
        step_logits=logits)
    worst = 0.0
    for b, plen in enumerate(plens):
        steps = np.arange(plen - 1, num_steps)
        scaled = logits[b, steps, :vocab]
        noise = torch.zeros_like(scaled)
        top_k, top_p = 0, 0.0
        if temps[b] > 0:
            scaled = scaled / float(temps[b])
            noise = gumbel_rows(seed, b, steps, vpad, device)[:, :vocab]
            top_k, top_p = int(topks[b]), float(topps[b])
        scale = float(scaled.abs().max())
        tokens = torch.as_tensor(streams[b, steps + 1], dtype=torch.long, device=device)
        gap = sampled_token_gap(scaled, noise, tokens, top_k, top_p, BF16_LOGIT_REL_TOL * scale)
        if not gap <= BF16_LOGIT_REL_TOL * scale:
            raise AssertionError(f"row {b}: a token scores {gap} below the best it could have "
                                 f"sampled > {BF16_LOGIT_REL_TOL} x {scale}")
        worst = max(worst, gap / scale)
    return worst


def wide_vs_plain(device, flagship) -> float:
    """Phase 8a; returns the largest float32 last-step logits error."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_wide as dw
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate

    worst = 0.0
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, 390, (8, 9)).astype(np.int32)
    plens = np.array([9, 3, 6, 1, 9, 4, 7, 2], np.int32)
    greedy = (0.0, 0, 0.0)

    def check(name, packed, config, sampling, *, rows=8, length=142, cache_len=WIDE_CHECK_CACHE,
              quantize_kv=False):
        """float32: identical ids and last-step logits within F32_LOGIT_TOL.
        int8 weights compute on bf16-rounded activations, where a rounding
        can move by one bf16 step and a near-tie flip: the bf16 rule on the
        kernel's ids teacher-forced through the plain version."""
        nonlocal worst
        sampling = tuple(v[:rows] if np.ndim(v) else v for v in sampling)
        args = (packed, config, prompts[:rows], plens[:rows], sampling)
        kwargs = dict(length=length, cache_len=cache_len, quantize_kv=quantize_kv)
        ours, logits, state = wide_run(*args, **kwargs)
        plain, plain_logits, _ = wide_run(*args, **kwargs, plain=True)
        agree = float((ours == plain).float().mean())
        if packed["big_w"].dtype != torch.float32:
            gap = wide_teacher_forced_gap(*args, ours, cache_len=cache_len,
                                          quantize_kv=quantize_kv)
            print(f"wide {name}: ids agreement with the plain version {agree:.4f}; every token, "
                  f"teacher-forced through it, within {gap:.3e} of scale (limit "
                  f"{BF16_LOGIT_REL_TOL})", flush=True)
            return ours, state
        err = float((logits - plain_logits).abs().max())
        if not torch.equal(ours, plain):
            raise AssertionError(f"wide {name}: kernel and plain version differ, agreement "
                                 f"{agree:.4f}")
        if err > F32_LOGIT_TOL:
            raise AssertionError(f"wide {name}: last-step logits differ by {err} > "
                                 f"{F32_LOGIT_TOL}")
        worst = max(worst, err)
        print(f"wide {name}: ids identical ({ours.shape[0]} x {ours.shape[1]}, "
              f"{len(set(ours.ravel().tolist()))} distinct), last-step logits max_abs_err "
              f"{err:.3e} (limit {F32_LOGIT_TOL})", flush=True)
        return ours, state

    for use_relative in (False, True):
        model, _ = build_model(use_relative, device)
        config = model.config
        packed = dw.pack_weights_wide(model.state_dict(), config, dtype=torch.float32)
        fused = dk.pack_weights(model.state_dict(), config, dtype=torch.float32, device=device)
        for kind, sampling in (("greedy", greedy), ("sampled", WIDE_SAMPLED)):
            ours, _ = check(f"default rel={use_relative} {kind} f32", packed, config, sampling)
            rows = dk.row_params(8, 512, *sampling, *dk.sampling_flags(*sampling), device)
            theirs = decode_generate(
                fused, torch.as_tensor(prompts, device=device), torch.as_tensor(plens, device=device),
                3, *rows, None, None, config=config, num_steps=150, out_len=150,
                cache_len=WIDE_CHECK_CACHE, start_step=0).cpu()
            if not torch.equal(ours, theirs):
                raise AssertionError(f"wide default rel={use_relative} {kind}: ids differ from "
                                     "decode_generate's")
        print(f"wide default rel={use_relative}: greedy and sampled ids equal one "
              "decode_generate launch with the same seed", flush=True)
    check("default B=1 x (9 + 592) greedy f32 (8 key splits)", packed, config, greedy, rows=1,
          length=592, cache_len=640)
    check("default f32 weights + int8 K/V sampled", packed, config, WIDE_SAMPLED,
          quantize_kv=True)
    int8 = dw.pack_weights_wide(model.state_dict(), config, dtype=torch.int8)
    check("default int8 weights + int8 K/V sampled", int8, config, WIDE_SAMPLED,
          quantize_kv=True)

    config = flagship.config
    packed = dw.pack_weights_wide(flagship.state_dict(), config, dtype=torch.float32)
    check("flagship greedy f32", packed, config, greedy)
    _, state = check("flagship sampled f32", packed, config, WIDE_SAMPLED)
    check("flagship B=1 greedy f32", packed, config, greedy, rows=1)
    # The sampled run's state, dirtied, serves other prompts: equal to fresh.
    other = np.roll(prompts, 1, axis=0)
    args = (packed, config, other, plens, WIDE_SAMPLED)
    reused, _, _ = wide_run(*args, length=142, cache_len=WIDE_CHECK_CACHE, state=state)
    fresh, _, _ = wide_run(*args, length=142, cache_len=WIDE_CHECK_CACHE)
    if not torch.equal(reused, fresh):
        raise AssertionError("wide: a reused K/V state gives other ids than a fresh one")
    print("wide flagship: a second call on the reused K/V state equals a fresh one", flush=True)
    del packed, state
    int8 = dw.pack_weights_wide(flagship.state_dict(), config, dtype=torch.int8)
    for quantize_kv in (False, True):
        check(f"flagship int8 weights{' + int8 K/V' if quantize_kv else ''} sampled", int8,
              config, WIDE_SAMPLED, quantize_kv=quantize_kv)
    return worst


def wide_bound(packed, config, batch: int, num_steps: int, kv_bytes: int):
    """One wide generation. Each step streams the matmul weights and the
    tied head again: about 200 MB at embed 1024 against the H100's 50 MB of
    L2 and 33 MB of shared memory, so they cannot stay on chip. The other
    tables, the prompts and the ids move once. Per step and layer each row
    writes one K/V row and reads its prefix [0, pos] (``kv_bytes`` a value,
    int8 rows with their two float32 scales), and the step reads the
    relative band once (``min(pos + 1, W)`` rows, shared by the rows). The
    operations are decode_bound's."""
    E, L, W = config.embed_dim, config.num_layers, config.window_size
    size = {name: t.numel() * t.element_size() for name, t in packed.items()}
    streamed = sum(size.get(name, 0) for name in ("big_w", "fp_w", "wscale", "fpscale",
                                                  "logits_w"))
    once = sum(size.values()) - streamed
    if not config.use_relative_attention:
        once -= size["rel_rows"]
    steps = np.arange(num_steps)
    keys = int((steps + 1).sum())
    band_rows = int(np.minimum(steps + 1, W).sum()) if config.use_relative_attention else 0
    kv_row = 2 * E * kv_bytes + (8 if kv_bytes == 1 else 0)
    byte_count = (num_steps * streamed + once + L * batch * (keys + num_steps) * kv_row
                  + L * band_rows * E * packed["rel_rows"].element_size()
                  + batch * (PROMPT_EVENTS + num_steps + 1) * 4)
    per_key = 6 if config.use_relative_attention else 4
    flops = batch * (num_steps * (L * 24 * E * E + 2 * E * config.vocab_size)
                     + L * per_key * E * keys)
    return bound(byte_count, flops)


def flagship_path(device, card: str, flagship, yaml_config) -> dict:
    """Phase 8b: the flagship through ``generate_ids(engine="auto")`` in
    bf16, B=8 x (10 + 1014) and B=1 x (10 + 1014), sampled."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.ops import _build
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_wide as dw
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.ops.decode_kernel_spec import teacher_forced_logits
    from composer_tpu_torch.train import generate as gen

    config = flagship.config
    prompt = encoded_prompt(yaml_config, PROMPT_EVENTS)
    # Packs the weights; not counted.
    gen.generate_ids(flagship, ModelType.TRANSFORMER, None, prompt, length=16, engine="auto")
    spans = KernelSpans(_build.load_library("decode_wide"))
    load_library = _build.load_library

    def call(prompts, seed):
        """(ids, host wall s, device window ms, kernel ms) of one call."""
        window = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        spans.spans.clear()
        torch.cuda.synchronize()
        start = time.perf_counter()
        window[0].record()
        ids = gen.generate_ids(flagship, ModelType.TRANSFORMER, None, prompts,
                               length=GENERATE_EVENTS, temperature=1.0, seed=seed,
                               engine="auto")
        window[1].record()
        wall = time.perf_counter() - start
        return ids, wall, window[0].elapsed_time(window[1]), spans.ms()

    _build.load_library = lambda name="decode_generate": (
        spans if name == "decode_wide" else load_library(name))
    try:
        dw.decode_wide.launches = 0
        decode_generate.launches_batched = decode_generate.launches_single = 0
        ids8, wall8, window8, kernel8 = call(np.tile(prompt, (8, 1)), 2)
        ids1, wall1, window1, kernel1 = call(prompt, 3)
        launches = dw.decode_wide.launches
        fused = decode_generate.launches_batched + decode_generate.launches_single
    finally:
        _build.load_library = load_library
    print(f"flagship main path: decode_wide launches {launches}, decode_generate launches "
          f"{fused}", flush=True)
    if launches != 2 or fused:
        raise AssertionError("auto did not route the flagship to the wide kernel")
    engine = gen._WIDE_ENGINE_CACHE["engine"]
    if engine.packed["big_w"].dtype != torch.bfloat16:
        raise AssertionError("the wide engine did not pack bf16 weights on the card")
    with tempfile.TemporaryDirectory() as tmp:
        size = write_midi(ids8[0], yaml_config, Path(tmp) / "flagship.mid")
    if size <= 0:
        raise AssertionError("the MIDI file is empty")

    # Every emitted token, teacher-forced through the plain bf16 forward with
    # the kernel's Philox noise of (seed, row, step), must be one a kernel
    # could have sampled with every logit within 1% of their scale.
    fused_packed = dk.pack_weights(flagship.state_dict(), config, dtype=torch.bfloat16,
                                   device=device)
    worst = 0.0
    for name, ids, seed in (("B=8", ids8, 2), ("B=1", ids1[None], 3)):
        if ids.shape[1] != PROMPT_EVENTS + GENERATE_EVENTS or ids.min() < 0 or ids.max() >= 390:
            raise AssertionError(f"flagship {name}: bad ids {ids.shape}")
        for row, stream in enumerate(ids):
            logits = teacher_forced_logits(fused_packed, stream, config=config)
            logits = logits[PROMPT_EVENTS - 1:-1, :390]
            steps = PROMPT_EVENTS - 1 + np.arange(GENERATE_EVENTS)
            noise = gumbel_rows(seed, row, steps, 512, device)[:, :390]
            scale = float(logits.abs().max())
            tokens = torch.as_tensor(stream[PROMPT_EVENTS:], dtype=torch.long, device=device)
            gap = sampled_token_gap(logits, noise, tokens, 0, 0.0, BF16_LOGIT_REL_TOL * scale)
            if not gap <= BF16_LOGIT_REL_TOL * scale:
                raise AssertionError(f"flagship {name} row {row}: a token scores {gap} below "
                                     f"its row's max > {BF16_LOGIT_REL_TOL} x {scale}")
            worst = max(worst, gap / scale)
        print(f"flagship {name}: {ids.shape[0]} x {ids.shape[1]} ids, "
              f"{len(set(ids[:, PROMPT_EVENTS:].ravel().tolist()))} distinct generated; every "
              f"token teacher-forced through the plain bf16 forward within "
              f"{worst:.3e} of scale (limit {BF16_LOGIT_REL_TOL})", flush=True)
    print(f"flagship MIDI written: {size} bytes", flush=True)
    for name, batch, wall, window, kernel in (("B=8", 8, wall8, window8, kernel8),
                                              ("B=1", 1, wall1, window1, kernel1)):
        print(f"flagship generate_ids {name} x {GENERATE_EVENTS}: "
              f"{batch * GENERATE_EVENTS / wall:.1f} events/s ({wall:.3f} s host clock); device "
              f"window {window:.3f} ms, kernel {kernel:.3f} ms, busy share "
              f"{kernel / window:.5f} [{card}]", flush=True)
    return {"launches": launches, "engine": engine, "fused_packed": fused_packed,
            "prompt": prompt}


def wide_clock_line(clock, steps: int) -> str:
    """The kernel's clock (``PHASES``): block 0's own work by phase kind and
    its barrier wait, each with its share, and the grid barriers a step."""
    from composer_tpu_torch.ops import decode_kernel_wide as dw

    values = clock.cpu().numpy()
    ms = values[:-1] / 1e6
    parts = ", ".join(f"{name} {t:.2f} ms ({t / ms.sum():.3f})"
                      for name, t in zip(dw.PHASES[:-1], ms))
    return (f"{parts}; {ms.sum():.2f} ms in all; {int(values[-1])} grid barriers, "
            f"{values[-1] / steps:.2f} a step")


def wide_timings(device, card: str, flagship, path: dict, default_fused_ms: float,
                 parent=None) -> dict:
    """Phase 8c: the kernel in bf16, int8 weights and int8 weights + int8 K/V
    (CUDA events, after a warm-up), the plain version (host clock after a
    synchronize) and one decode_generate launch on the same weights, at
    B=8 and B=1 x (10 + 1014), sampled; the bf16 runs twice with identical
    ids (a race between blocks shows as ids that differ only sometimes),
    and the kernel's clock with its grid barriers a step. Given ``parent``
    (``parent_libraries``), that checkout's kernel on the same bf16
    inputs in turns (parent, this, this, parent), and its float32 greedy
    ids against this kernel's. Then the default model's wide time beside
    decode_generate's."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_wide as dw
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate

    config = flagship.config
    packs = {"bf16": (path["engine"].packed, False),
             "int8": (dw.pack_weights_wide(flagship.state_dict(), config, torch.int8), False)}
    packs["int8 + int8 K/V"] = (packs["int8"][0], True)
    num_steps = PROMPT_EVENTS + GENERATE_EVENTS - 1
    sampled = (1.0, 0, 0.0)
    result = {}
    for batch in (8, 1):
        prompts = np.tile(path["prompt"], (batch, 1))
        plens = np.full(batch, PROMPT_EVENTS, np.int32)
        events = batch * GENERATE_EVENTS
        times = {}
        for name, (packed, quantize_kv) in packs.items():
            state = dw.init_kv_state(config, batch, 1024, packed["wte"].dtype, quantize_kv,
                                     device)
            times[name] = cuda_ms(lambda: wide_run(packed, config, prompts, plens, sampled,
                                                   length=GENERATE_EVENTS, cache_len=1024,
                                                   state=state), 2)
            kv_bytes = 1 if quantize_kv else 2
            ms, by = wide_bound(packed, config, batch, num_steps, kv_bytes)
            print(f"flagship wide kernel {name} B={batch} x {GENERATE_EVENTS}: "
                  f"{times[name]:.2f} ms ({events / times[name] * 1e3:.1f} events/s); bound "
                  f"{ms:.2f} ms ({by}) [{card}]", flush=True)
            times[f"bound {name}"] = (ms, by)
        bf16_args = (packs["bf16"][0], config, prompts, plens, sampled)
        bf16_kwargs = dict(length=GENERATE_EVENTS, cache_len=1024)
        first, second = (wide_run(*bf16_args, **bf16_kwargs)[0] for _ in range(2))
        if not torch.equal(first, second):
            raise AssertionError(f"wide bf16 B={batch}: two runs of the same launch give other "
                                 f"ids (agreement {float((first == second).float().mean()):.4f})")
        print(f"flagship wide kernel bf16 B={batch}: two runs give identical ids", flush=True)
        # Where the time goes: the kernel's clock (block 0's own work by
        # phase, its barrier wait, the barrier count), one more bf16 run.
        clock = torch.zeros(len(dw.PHASES), dtype=torch.int64, device=device)
        wide_run(*bf16_args, **bf16_kwargs, phase_ns=clock)
        clock_ms = clock.cpu().numpy()[:-1] / 1e6
        print(f"flagship wide kernel bf16 B={batch} by phase: "
              f"{wide_clock_line(clock, num_steps)} [{card}]", flush=True)
        parent_ms = None
        if parent is not None:
            lib = parent["decode_wide"]

            def parent_time():
                return with_library("decode_wide", lib,
                                    lambda: cuda_ms(lambda: wide_run(*bf16_args, **bf16_kwargs), 1))

            parent_ms = [parent_time()]
            ours = [cuda_ms(lambda: wide_run(*bf16_args, **bf16_kwargs), 1) for _ in range(2)]
            parent_ms.append(parent_time())
            print(f"flagship wide kernel bf16 B={batch} x {GENERATE_EVENTS}, the parent "
                  f"checkout's kernel on the same inputs (parent, this, this, parent): "
                  f"{parent_ms[0]:.2f}, {ours[0]:.2f}, {ours[1]:.2f}, {parent_ms[1]:.2f} ms; "
                  f"{min(parent_ms) / max(ours):.3f}x [{card}]", flush=True)
            if "decode_wide" not in parent["unchanged"] and not max(ours) < min(parent_ms):
                raise AssertionError(f"wide B={batch}: not faster than the parent's kernel")
            if batch == 8:
                f32 = dw.pack_weights_wide(flagship.state_dict(), config, torch.float32)
                check = np.random.default_rng(8).integers(0, 390, (8, 9)).astype(np.int32)
                f32_args = (f32, config, check, np.array([9, 3, 6, 1, 9, 4, 7, 2], np.int32),
                            (0.0, 0, 0.0))
                f32_kwargs = dict(length=142, cache_len=WIDE_CHECK_CACHE)
                ours_ids = wide_run(*f32_args, **f32_kwargs)[0]
                theirs = with_library("decode_wide", lib,
                                      lambda: wide_run(*f32_args, **f32_kwargs)[0])
                print(f"flagship wide f32 greedy 8 x (9 + 142): ids agreement with the parent's "
                      f"kernel {float((ours_ids == theirs).float().mean()):.4f}", flush=True)
                del f32
        plain_ms = None  # timed at B=8 only (15-20 s a call)
        if batch == 8:
            start = time.perf_counter()
            wide_run(packs["bf16"][0], config, prompts, plens, sampled, length=GENERATE_EVENTS,
                     cache_len=1024, plain=True)
            plain_ms = (time.perf_counter() - start) * 1e3
        rows = dk.row_params(batch, 512, *sampled, *dk.sampling_flags(*sampled), device)
        fused_args = (path["fused_packed"], torch.as_tensor(prompts, device=device),
                      torch.as_tensor(plens, device=device), 0, *rows, None, None)

        def fused(steps):
            return decode_generate(*fused_args, config=config, num_steps=steps,
                                   out_len=steps - PROMPT_EVENTS + 1, cache_len=1024,
                                   start_step=0)

        fused(PROMPT_EVENTS + 15)  # warm-up
        fused_ms = cuda_ms(lambda: fused(num_steps), 1)
        plain = ("not timed" if plain_ms is None
                 else f"{plain_ms:.2f} ms ({events / plain_ms * 1e3:.1f} events/s)")
        print(f"flagship B={batch} x {GENERATE_EVENTS} bf16: wide kernel {times['bf16']:.2f} ms, "
              f"plain version {plain}, "
              f"decode_generate (auto's route before the wide kernel) {fused_ms:.2f} ms "
              f"({events / fused_ms * 1e3:.1f} events/s); wide is "
              f"{fused_ms / times['bf16']:.2f}x faster [{card}]", flush=True)
        result[batch] = dict(times, plain_ms=plain_ms, fused_ms=fused_ms, clock_ms=clock_ms,
                             parent_ms=parent_ms)

    model, _ = build_model(False, device)
    packed = dw.pack_weights_wide(model.state_dict(), model.config, torch.bfloat16)
    prompts = np.tile(path["prompt"], (8, 1))
    state = dw.init_kv_state(model.config, 8, 1024, torch.bfloat16, device=device)
    default_ms = cuda_ms(lambda: wide_run(packed, model.config, prompts,
                                          np.full(8, PROMPT_EVENTS, np.int32), sampled,
                                          length=GENERATE_EVENTS, cache_len=1024,
                                          state=state), 2)
    print(f"default model B=8 x {GENERATE_EVENTS} bf16 (finding, not a route): wide kernel "
          f"{default_ms:.2f} ms against decode_generate {default_fused_ms:.2f} ms [{card}]",
          flush=True)
    return result


WIDE_SEGMENT_STARTS = np.array([0, 0, 0, 0, 3, 0, 2**30, 40], np.int32)  # 6 parked, 4 and 7 late


def wide_segment_stream(packed, config, prompts, plens, starts, boundaries, sampling, *,
                        cache_len, plain=False, live=None, seed=3):
    """One run of ``decode_segment_wide`` (or its plain version) over the
    segments ``boundaries`` on fresh state: ``(stream (B, steps), carry)`` on
    the host. ``live=None`` grows it as the service does."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_wide_segmented as dws

    device = packed["wte"].device
    rows = dk.row_params(len(prompts), packed["wte"].shape[0], *sampling,
                         *dk.sampling_flags(*sampling), device)
    host = [torch.as_tensor(t, dtype=torch.int32, device=device) for t in (prompts, plens, starts)]
    kv, carry = dws.init_wide_segment_state(packed, config, len(prompts), cache_len)
    active = starts != dws.PARKED
    chunks = []
    for b0, b1 in zip(boundaries[:-1], boundaries[1:]):
        reach = int((b1 - starts[active]).max())
        kwargs = dict(config=config, steps=b1 - b0, cache_len=cache_len,
                      live=live or min(cache_len, -(-reach // 256) * 256))
        if plain:
            tokens = dws.decode_segment_wide_reference(packed, kv, carry, *host, b0, seed, *rows,
                                                       **kwargs)
        else:
            tokens, kv, carry = dws.decode_segment_wide(packed, kv, carry, prompts, plens, starts,
                                                        b0, seed, *sampling, **kwargs)
        chunks.append(tokens)
    torch.cuda.synchronize()
    return torch.cat(chunks, dim=1).cpu(), carry.cpu()


def wide_segment_vs_plain(device, flagship) -> int:
    """Phase 9a; returns the largest |kernel - plain| over ids and carry."""
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_segmented as seg
    from composer_tpu_torch.ops import decode_kernel_wide as dw

    worst = 0
    greedy = (0.0, 0, 0.0)
    rng = np.random.default_rng(17)
    prompts = rng.integers(0, 390, (8, 10)).astype(np.int32)
    plens = np.array([10, 4, 7, 1, 10, 6, 9, 2], np.int32)
    starts = WIDE_SEGMENT_STARTS
    steps = WIDE_CHECK_CACHE - 106  # 150 steps at cache 256: up to 3 key splits a row
    cuts = {length: list(range(0, steps, length)) + [steps] for length in (1, 7, 64)}
    models = [(f"default rel={rel}", build_model(rel, device)[0]) for rel in (False, True)]
    for name, model in models + [("flagship", flagship)]:
        config = model.config
        packed = dw.pack_weights_wide(model.state_dict(), config, dtype=torch.float32)
        for kind, sampling in (("greedy", greedy), ("sampled", WIDE_SAMPLED)):
            args = (packed, config, prompts, plens, starts)
            plain = wide_segment_stream(*args, cuts[64], sampling, cache_len=WIDE_CHECK_CACHE,
                                        live=WIDE_CHECK_CACHE, plain=True)
            for length, boundaries in cuts.items():
                ours = wide_segment_stream(*args, boundaries, sampling,
                                           cache_len=WIDE_CHECK_CACHE, live=WIDE_CHECK_CACHE)
                diff = max(int((a.long() - b.long()).abs().max()) for a, b in zip(ours, plain))
                worst = max(worst, diff)
                if diff:
                    raise AssertionError(f"wide segment {name} {kind} segments of {length}: "
                                         "kernel and plain version disagree")
            stream = ours[0]
            if (stream[6] != -1).any() or (stream[7, :40] != -1).any() \
                    or (stream[4, :3] != -1).any():
                raise AssertionError("a parked slot emitted a token")
            print(f"wide segment f32 {name} {kind}: ids and carry identical to the plain version "
                  f"under segments of 1, 7 and 64 (8 slots, one parked, two late, {steps} steps, "
                  f"cache {WIDE_CHECK_CACHE}), {len(set(plain[0].flatten().tolist()))} distinct "
                  "ids", flush=True)
            if name.startswith("default"):
                resident = dk.pack_weights(model.state_dict(), config, dtype=torch.float32,
                                           device=device)
                theirs = segment_stream(resident, config, prompts, plens, starts, cuts[64],
                                        sampling, cache_len=WIDE_CHECK_CACHE,
                                        live=WIDE_CHECK_CACHE)
                if not all(torch.equal(a, b) for a, b in zip(theirs, plain)):
                    raise AssertionError(f"wide segment {name} {kind}: differs from "
                                         "decode_segment")
            if kind == "greedy":
                whole, _, _ = wide_run(packed, config, prompts, plens, greedy,
                                       length=steps - 9, cache_len=WIDE_CHECK_CACHE)
                for row in np.flatnonzero(starts != 2**30):
                    first = int(starts[row]) + int(plens[row]) - 1
                    count = steps - first
                    if not torch.equal(stream[row, first:], whole[row, :count]):
                        raise AssertionError(f"wide segment {name} greedy row {row}: differs "
                                             "from decode_wide")
        print(f"wide segment f32 {name}: greedy ids equal one decode_wide launch (each row from "
              f"its own position 0){'; greedy and sampled ids and carry equal decode_segment' if name.startswith('default') else ''}",
              flush=True)
    del packed
    config = flagship.config
    int8 = dw.pack_weights_wide(flagship.state_dict(), config, dtype=torch.int8)
    zero = np.zeros(8, np.int32)
    ours, _ = wide_segment_stream(int8, config, prompts, plens, zero, cuts[64], WIDE_SAMPLED,
                                  cache_len=WIDE_CHECK_CACHE, live=WIDE_CHECK_CACHE)
    ids = torch.zeros((8, steps), dtype=torch.int32)  # decode_wide's column layout
    for row, plen in enumerate(plens):
        ids[row, :steps - plen + 1] = ours[row, plen - 1:]
    gap = wide_teacher_forced_gap(int8, config, prompts, plens, WIDE_SAMPLED, ids,
                                  cache_len=WIDE_CHECK_CACHE)
    print(f"wide segment flagship int8 weights sampled: every token, teacher-forced through the "
          f"plain version, within {gap:.3e} of scale (limit {BF16_LOGIT_REL_TOL})", flush=True)
    return worst


def wide_segment_bound(packed, config, starts, step0: int, steps: int, live: int):
    """One segment of the wide segment kernel: per step the streamed weights
    once (they exceed the card's on-chip memory, ``wide_bound``), the other
    tables, prompts, per-row inputs and ids once; per step and active row
    and layer its K/V row written and its prefix [0, min(pos, live-1)] read,
    and the relative-table rows the active rows' bands reach, once a step.
    The operations are ``segment_bound``'s."""
    E, L, W = config.embed_dim, config.num_layers, config.window_size
    size = {name: t.numel() * t.element_size() for name, t in packed.items()}
    streamed = sum(size.get(name, 0) for name in ("big_w", "fp_w", "wscale", "fpscale",
                                                  "logits_w"))
    once = sum(size.values()) - streamed - size["rel_rows"]
    kv_row = 2 * E * packed["wte"].element_size()
    per_key = 6 if config.use_relative_attention else 4
    byte_count, flops = once + len(starts) * (PROMPT_EVENTS + steps + 8) * 4, 0
    for i in range(step0, step0 + steps):
        pos = i - starts[starts != 2**30].astype(np.int64)
        pos = pos[pos >= 0]
        if not len(pos):
            continue
        keys = np.minimum(pos, live - 1) + 1
        byte_count += streamed + L * kv_row * int(keys.sum() + (pos < live).sum())
        if config.use_relative_attention:
            byte_count += L * min(int(keys.max()), W) * E * packed["rel_rows"].element_size()
        flops += len(pos) * (L * 24 * E * E + 2 * E * config.vocab_size)
        flops += L * per_key * E * int(keys.sum())
    return bound(byte_count, flops)


def wide_segment_timings(device, card: str, flagship, parent=None) -> dict:
    """Phase 9b: the kernel on the flagship in bf16 at the service's shape (8
    rows x (10 + 1014) in 16 segments of 64, cache 2048, greedy), per
    segment, run twice with identical ids, against the plain version, the
    bound and one decode_wide launch for the same generation (the cost of
    segmenting); given ``parent``, that checkout's kernel on the same
    inputs in turns (parent, this, this, parent)."""
    from composer_tpu_torch.ops import _build
    from composer_tpu_torch.ops import decode_kernel_wide as dw
    from composer_tpu_torch.ops import decode_kernel_wide_segmented as dws

    config = flagship.config
    packed = dw.pack_weights_wide(flagship.state_dict(), config, dtype=torch.bfloat16)
    prompts = np.random.default_rng(19).integers(0, 390, (8, PROMPT_EVENTS)).astype(np.int32)
    plens = np.full(8, PROMPT_EVENTS, np.int32)
    starts = np.zeros(8, np.int32)
    greedy = (0.0, 0, 0.0)
    boundaries = list(range(0, 16 * SEGMENT_STEPS + 1, SEGMENT_STEPS))
    args = (packed, config, prompts, plens, starts, boundaries, greedy)
    wide_segment_stream(*args, cache_len=SERVE_CACHE)  # warm-up

    def segment_ms(lib):
        """(ms per segment over one 16-segment stream, the stream)."""
        spans = KernelSpans(lib)
        stream, _ = with_library("decode_wide_segment", spans,
                                 lambda: wide_segment_stream(*args, cache_len=SERVE_CACHE))
        torch.cuda.synchronize()
        return [begin.elapsed_time(end) for begin, end in spans.spans], stream

    own = _build.load_library("decode_wide_segment")
    runs = [segment_ms(own) for _ in range(2)]
    if not torch.equal(runs[0][1], runs[1][1]):
        raise AssertionError("wide segment bf16: two runs of the same segments give other ids")
    ours = runs[1][1]
    per_segment = runs[0][0] + runs[1][0]
    kernel_ms = float(np.mean(per_segment))
    parent_ms = None
    if parent is not None:
        lib = parent["decode_wide_segment"]
        parent_ms = [float(np.mean(segment_ms(lib)[0]))]
        again = [float(np.mean(segment_ms(own)[0])) for _ in range(2)]
        parent_ms.append(float(np.mean(segment_ms(lib)[0])))
        print(f"wide segment kernel bf16 per segment, the parent checkout's kernel on the same "
              f"inputs (parent, this, this, parent): {parent_ms[0]:.3f}, {again[0]:.3f}, "
              f"{again[1]:.3f}, {parent_ms[1]:.3f} ms; {min(parent_ms) / max(again):.3f}x "
              f"[{card}]", flush=True)
        if "decode_wide_segment" not in parent["unchanged"] and not max(again) < min(parent_ms):
            raise AssertionError("wide segment: not faster than the parent's kernel")
    clock = torch.zeros(len(dw.PHASES), dtype=torch.int64, device=device)
    kv, carry = dws.init_wide_segment_state(packed, config, 8, SERVE_CACHE)
    dws.decode_segment_wide(packed, kv, carry, prompts, plens, starts, 0, 3, *greedy,
                            config=config, steps=SEGMENT_STEPS, cache_len=SERVE_CACHE,
                            live=256, phase_ns=clock)
    print(f"wide segment kernel bf16, first segment by phase: "
          f"{wide_clock_line(clock, SEGMENT_STEPS)} [{card}]", flush=True)
    start = time.perf_counter()
    plain, _ = wide_segment_stream(*args, cache_len=SERVE_CACHE, plain=True)
    plain_ms = (time.perf_counter() - start) * 1e3 / 16
    bounds = [wide_segment_bound(packed, config, starts, b0, SEGMENT_STEPS,
                                 min(SERVE_CACHE, -(-(b0 + SEGMENT_STEPS) // 256) * 256))
              for b0 in boundaries[:-1]]
    bound_ms = float(np.mean([ms for ms, _ in bounds]))
    bound_by = bounds[-1][1]
    whole_args = (packed, config, prompts, plens, greedy)
    whole_kwargs = dict(length=GENERATE_EVENTS, cache_len=SERVE_CACHE,
                        state=dw.init_kv_state(config, 8, SERVE_CACHE, torch.bfloat16,
                                               device=device))
    whole, _, _ = wide_run(*whole_args, **whole_kwargs)
    whole_ms = cuda_ms(lambda: wide_run(*whole_args, **whole_kwargs), 1)
    generated = ours[:, PROMPT_EVENTS - 1:PROMPT_EVENTS - 1 + GENERATE_EVENTS]
    agree = float((generated == whole[:, :GENERATE_EVENTS]).float().mean())
    agree_plain = float((ours == plain).float().mean())
    half = len(per_segment) // 2
    print(f"wide segment kernel bf16, flagship, 8 live rows x {SEGMENT_STEPS} steps, cache "
          f"{SERVE_CACHE}: {kernel_ms:.3f} ms per segment (mean of {len(per_segment)} over two "
          f"runs; first segment {per_segment[half]:.3f} ms, last {per_segment[-1]:.3f} ms; "
          f"{kernel_ms / SEGMENT_STEPS * 1e3:.1f} us per step); plain version {plain_ms:.2f} ms "
          f"per segment (ids agreement {agree_plain:.4f}); bound {bound_ms:.4f} ms ({bound_by}) "
          f"[{card}]", flush=True)
    print(f"flagship 8 x {GENERATE_EVENTS} bf16 greedy: 16 segments {16 * kernel_ms:.2f} ms "
          f"against one decode_wide launch {whole_ms:.2f} ms (cost of segmenting "
          f"{16 * kernel_ms / whole_ms:.4f}x); ids agreement with decode_wide {agree:.4f} "
          f"[{card}]", flush=True)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "whole_ms": whole_ms, "first_ms": per_segment[half:half + 2], "parent_ms": parent_ms}


def wide_serve_path(device, card: str, flagship, first_ms) -> dict:
    """Phase 9c: ``ContinuousGenerationService(engine="auto")`` on the
    flagship with the `serve` defaults: ``auto`` must take the wide engine.
    16 requests of 10 + 1014 events from 16 threads at once, 8 greedy and 8
    sampled; then two segments of the resident route ``auto`` took before,
    timed on the same weights."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.ops import _build
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_segmented as seg
    from composer_tpu_torch.ops import decode_kernel_wide_segmented as dws
    from composer_tpu_torch.ops.decode_kernel_spec import teacher_forced_logits
    from composer_tpu_torch.serving import ContinuousGenerationService

    config = flagship.config
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 390, PROMPT_EVENTS).astype(np.int32) for _ in range(16)]
    sampling = [(0.0, 0, 0.0)] * 8 + [(1.0, k, p) for k, p in (
        (0, 0.0), (40, 0.0), (0, 0.9), (20, 0.95), (5, 0.0), (0, 0.8), (100, 0.9), (0, 0.0))]
    service = ContinuousGenerationService(flagship, ModelType.TRANSFORMER, None, 390)
    results, admitted = [None] * 16, {}
    spans = KernelSpans(_build.load_library("decode_wide_segment"))
    load_library = _build.load_library
    try:
        if not service.wide or (service.slots, service.seg_steps, service.cache_len,
                                service.capacity) != (SERVE_SLOTS, SEGMENT_STEPS, SERVE_CACHE,
                                                      SERVE_CACHE) \
                or service.packed["big_w"].dtype != torch.bfloat16:
            raise AssertionError("auto did not take the wide engine with the serve defaults")
        service.submit(prompts[1], 64, temperature=0.0, deadline_ms=300_000)  # warm-up
        admit = service._admit

        def record(request, slot):
            admit(request, slot)
            admitted[request.prompt_ids.tobytes()] = (slot, int(service._starts[slot]))

        service._admit = record
        _build.load_library = lambda name="decode_wide_segment": spans
        segments_before = len(service.batch_sizes)

        def call(i):
            temperature, top_k, top_p = sampling[i]
            results[i] = service.submit(prompts[i], GENERATE_EVENTS, temperature=temperature,
                                        top_k=top_k, top_p=top_p, deadline_ms=600_000)

        threads = [threading.Thread(target=call, args=(i,), daemon=True) for i in range(16)]
        dws.decode_segment_wide.launches = 0
        seg.decode_segment.launches = 0
        start = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=600)
        wall = time.perf_counter() - start
        launches, resident_launches = dws.decode_segment_wide.launches, seg.decode_segment.launches
        stats = service.overload_stats()
        batch_sizes = service.batch_sizes[segments_before:]
    finally:
        _build.load_library = load_library
        service.close()
    busy_ms = spans.ms()
    window_ms = spans.spans[0][0].elapsed_time(spans.spans[-1][1])
    if any(r is None for r in results):
        raise AssertionError("a request of the flagship burst did not complete")
    print(f"flagship serve burst (auto -> wide): 16 x ({PROMPT_EVENTS} + {GENERATE_EVENTS}) from "
          f"16 threads in {wall:.3f} s (host clock), {16 * GENERATE_EVENTS / wall:.1f} events/s; "
          f"decode_segment_wide launches {launches}, decode_segment launches "
          f"{resident_launches}; device busy share {busy_ms / window_ms:.5f} ({busy_ms:.2f} ms "
          f"of a {window_ms:.2f} ms device window); latency p50 {stats['latency_p50_s']:.3f} s, "
          f"p95 {stats['latency_p95_s']:.3f} s; active rows per segment {batch_sizes} [{card}]",
          flush=True)
    if launches < 1 or resident_launches:
        raise AssertionError("the flagship service did not run on the wide segment kernel alone")

    # Every token, teacher-forced through the plain bf16 forward (a sampled
    # row adding the kernel's noise of its slot and global steps), must be
    # one the kernel could have picked with every logit within 1% of scale.
    resident = dk.pack_weights(flagship.state_dict(), config, dtype=torch.bfloat16,
                               device=device)
    worst = 0.0
    for i, ids in enumerate(results):
        if ids.shape != (PROMPT_EVENTS + GENERATE_EVENTS,) or ids.min() < 0 or ids.max() >= 390 \
                or not np.array_equal(ids[:PROMPT_EVENTS], prompts[i]):
            raise AssertionError(f"flagship request {i}: bad response {ids.shape}")
        logits = teacher_forced_logits(resident, ids, config=config)[PROMPT_EVENTS - 1:-1]
        temperature, top_k, top_p = sampling[i]
        scaled, noise = logits, torch.zeros_like(logits)
        if temperature > 0:
            slot, start_step = admitted[prompts[i].tobytes()]
            steps = start_step + PROMPT_EVENTS - 1 + np.arange(GENERATE_EVENTS)
            scaled = logits / temperature
            noise = gumbel_rows(service._seed, slot, steps, resident["wte"].shape[0], device)
        scale = float(scaled[:, :390].abs().max())
        tokens = torch.as_tensor(ids[PROMPT_EVENTS:], dtype=torch.long, device=device)
        gap = sampled_token_gap(scaled[:, :390], noise[:, :390], tokens, top_k, top_p,
                                BF16_LOGIT_REL_TOL * scale)
        if not gap <= BF16_LOGIT_REL_TOL * scale:
            raise AssertionError(f"flagship request {i}: a token scores {gap} below its row's "
                                 f"max > {BF16_LOGIT_REL_TOL} x {scale}")
        worst = max(worst, gap / scale)
    print(f"flagship serve burst: every token of the 16 responses, teacher-forced through the "
          f"plain bf16 forward, within {worst:.3e} of scale of the best lane surely kept (limit "
          f"{BF16_LOGIT_REL_TOL})", flush=True)

    # The finding behind the routing repair: the resident segment kernel, the
    # route `auto` took before, on the same weights, two segments from step 0.
    main = np.stack(prompts[:8])
    plens, starts = np.full(8, PROMPT_EVENTS, np.int32), np.zeros(8, np.int32)
    segment_stream(resident, config, main, plens, starts, [0, 4], (0.0, 0, 0.0),
                   cache_len=SERVE_CACHE)  # warm-up
    spans = KernelSpans(_build.load_library("decode_segment"))
    _build.load_library = lambda name="decode_segment": spans
    try:
        segment_stream(resident, config, main, plens, starts, [0, 64, 128], (0.0, 0, 0.0),
                       cache_len=SERVE_CACHE)
    finally:
        _build.load_library = load_library
    torch.cuda.synchronize()
    resident_ms = [begin.elapsed_time(end) for begin, end in spans.spans]
    print(f"flagship, first two segments of 64 steps x 8 rows, bf16: resident decode_segment "
          f"{resident_ms[0]:.2f} / {resident_ms[1]:.2f} ms against the wide segment kernel "
          f"{first_ms[0]:.2f} / {first_ms[1]:.2f} ms ({resident_ms[0] / first_ms[0]:.2f}x / "
          f"{resident_ms[1] / first_ms[1]:.2f}x) [{card}]", flush=True)
    return {"launches": launches, "wall": wall}


HTTP_TIMEOUT = 600  # seconds: the bound on every request of phase 10
FLAGSHIP_HTTP_EVENTS = 246  # phase 10d: 10 + 246 events, kept short for time


class HttpServing:
    """``build_server(service, config, port=0)`` on loopback in a daemon
    thread. ``close`` shuts the server down."""

    def __init__(self, service, yaml_config):
        from composer_tpu_torch.serving import build_server

        self.server = build_server(service, yaml_config, port=0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.server.server_port}{path}"

    def post(self, payload: dict):
        """The JSON response, or for ``stream`` the ndjson lines."""
        import urllib.request

        request = urllib.request.Request(self.url("/v1/generate"),
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=HTTP_TIMEOUT) as response:
            if payload.get("stream"):
                return [json.loads(line) for line in response]
            return json.loads(response.read())

    def health(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(self.url("/v1/health"), timeout=HTTP_TIMEOUT) as response:
            return json.loads(response.read())

    def post_all(self, payloads) -> list:
        """Posts every payload from its own thread at once; re-raises the
        first failure. ``self.client_s`` keeps each request's time on the
        client's clock, connection included."""
        results = [None] * len(payloads)
        self.client_s = [None] * len(payloads)

        def call(i):
            start = time.perf_counter()
            try:
                results[i] = self.post(payloads[i])
            except Exception as error:  # re-raised below, on the caller's thread
                results[i] = error
            self.client_s[i] = time.perf_counter() - start

        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(len(payloads))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=HTTP_TIMEOUT)
        for i, result in enumerate(results):
            if result is None or isinstance(result, Exception):
                raise AssertionError(f"request {i} failed: {result!r}")
        return results

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


class BatchSpy:
    """Records each ``generate_ids`` call of a ``GenerationService`` (the
    padded prompts, their lengths, the seed and the sampling vectors), so
    that a response can be traced to its batch row and Philox noise."""

    def __init__(self):
        from composer_tpu_torch.train import generate as gen

        self.gen, self.real, self.calls = gen, gen.generate_ids, []

        def spy(model, model_type, params, prompts, **kwargs):
            self.calls.append((np.asarray(prompts).copy(), kwargs))
            return self.real(model, model_type, params, prompts, **kwargs)

        gen.generate_ids = spy

    def restore(self):
        self.gen.generate_ids = self.real

    def row_of(self, prompt, temperature):
        """(seed, padded row, top_k, top_p) of the first batch row holding
        ``prompt`` at ``temperature`` (padding rows come after it)."""
        for prompts, kwargs in self.calls:
            for row, plen in enumerate(kwargs["prompt_lengths"]):
                if plen == len(prompt) and np.array_equal(prompts[row, :plen], prompt) \
                        and kwargs["temperature"][row] == np.float32(temperature):
                    return (kwargs["seed"], row, int(kwargs["top_k"][row]),
                            float(kwargs["top_p"][row]))
        raise AssertionError("a response has no batch row")


def served_token_gap(packed, config, ids, plen: int, temperature: float, noise_key) -> float:
    """The bf16 rule for one served response (prompt of ``plen`` ids, then
    its generation): teacher-forced through the plain bf16 forward, a sampled
    row adding the fused kernels' Philox noise of (seed, padded row, step),
    every token must be one a kernel could have picked with every logit
    within 1% of their scale (``sampled_token_gap``). Returns the gap over
    the scale."""
    from composer_tpu_torch.ops.decode_kernel_spec import teacher_forced_logits

    device, vpad, vocab = packed["wte"].device, packed["wte"].shape[0], config.vocab_size
    logits = teacher_forced_logits(packed, ids, config=config)[plen - 1:-1, :vocab]
    seed, row, top_k, top_p = noise_key
    scaled, noise = logits, torch.zeros_like(logits)
    if temperature > 0:
        steps = plen - 1 + np.arange(len(ids) - plen)
        scaled = logits / temperature
        noise = gumbel_rows(seed, row, steps, vpad, device)[:, :vocab]
    else:
        top_k, top_p = 0, 0.0
    scale = float(scaled.abs().max())
    tokens = torch.as_tensor(ids[plen:], dtype=torch.long, device=device)
    gap = sampled_token_gap(scaled, noise, tokens, top_k, top_p, BF16_LOGIT_REL_TOL * scale)
    if not gap <= BF16_LOGIT_REL_TOL * scale:
        raise AssertionError(f"a served token scores {gap} below the best it could have "
                             f"sampled > {BF16_LOGIT_REL_TOL} x {scale}")
    return gap / scale


def midi_prompt_body(yaml_config, pitch: int) -> dict:
    """A ``midi_base64`` prompt written by the port's MIDI codec."""
    import base64

    from composer_tpu_torch.midi.events import Note, NoteSequence

    notes = [Note(250.0 * i, 250.0 * i + 400.0, pitch + (i * 7) % 12, 60 + (i % 3) * 16)
             for i in range(12)]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "prompt.mid"
        NoteSequence(notes).to_midi(str(path))
        data = path.read_bytes()
    return {"midi_base64": base64.b64encode(data).decode(), "prompt_length": PROMPT_EVENTS,
            "return_midi": True}


def kernel_launch_counts() -> dict:
    """Every kernel wrapper's launch count, one key a kernel entry of the
    JSON line (the flash kernels by direction and variant)."""
    from composer_tpu_torch.ops import launch_counts

    return launch_counts()


def reset_kernel_launch_counts() -> None:
    from composer_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def admission_prefill_case(model, device) -> dict:
    """Phase 10e (and ``tests/test_torch_cuda_segment.py``): the continuous
    service's admission prefill and prefix cache on the card, float32
    weights. A 100-event prompt gives identical greedy ids when admitted
    token by token (``prefill_min`` 0), with the prefill forward
    (``prefill_min`` 4, no prefix cache) and from a prefix-cache hit; the
    hit counter rises once for the repeat. Returns the three services' ids
    and the cached service's gauges."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.serving import ContinuousGenerationService

    rng = np.random.default_rng(31)
    long_prompt = rng.integers(0, 390, 100).astype(np.int32)
    other = rng.integers(0, 390, 100).astype(np.int32)
    outputs, stats = {}, {}
    for label, prefill_min, cache_mb in (("forced", 0, 0.0), ("prefilled", 4, 0.0),
                                         ("cached", 4, 8.0)):
        service = ContinuousGenerationService(
            model, ModelType.TRANSFORMER, None, 390, slots=2, seg_steps=64, cache_len=512,
            dtype=torch.float32, prefill_min=prefill_min, prefix_cache_mb=cache_mb,
            device=device)
        try:
            outputs[label] = [service.submit(p, 64, temperature=0.0, deadline_ms=300_000)
                              for p in (long_prompt, long_prompt, other)]
            stats[label] = service.overload_stats()
        finally:
            service.close()
    for label in ("prefilled", "cached"):
        for index, (ours, forced) in enumerate(zip(outputs[label], outputs["forced"])):
            if not np.array_equal(ours, forced):
                raise AssertionError(f"{label} admission {index} differs from token-by-token "
                                     f"admission in {int((ours != forced).sum())} ids")
    if stats["prefilled"]["prefix_cache_hits"] or stats["cached"]["prefix_cache_hits"] != 1 \
            or stats["cached"]["prefix_cache_misses"] != 2:
        raise AssertionError(f"prefix cache counters: {stats}")
    return {"outputs": outputs, "stats": stats["cached"]}


def http_path(device, card: str, flagship, flagship_packed) -> dict:
    """Phase 10: the HTTP layer on the card, ``build_server`` on loopback
    with the `serve` defaults (``max_batch_size`` 8, ``max_wait_ms`` 20,
    ``default_length`` 1024), bf16: (a) a lone greedy request, (b) a burst
    of 16 from 16 threads, (c) ``ContinuousGenerationService`` behind the
    same handler, streaming, (d) the flagship, (e) the admission prefill and
    prefix cache in float32. Returns the launches of each kernel over
    (a)-(d)."""
    import base64

    from composer_tpu_torch.midi.midi_io import parse_midi
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.ops import _build
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.serving import (
        ContinuousGenerationService,
        GenerationService,
        _prompt_from_json,
    )
    from composer_tpu_torch.train import generate as gen

    start = time.perf_counter()
    model, yaml_config = build_model(False, device)
    config = model.config
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.bfloat16, device=device)
    launches = {}

    def megakernel(prompt, length):
        return gen.generate_ids(model, ModelType.TRANSFORMER, None, prompt, length=length,
                                temperature=0.0, engine="megakernel")

    # (a) A lone greedy request: the speculative kernel.
    prompt = encoded_prompt(yaml_config, PROMPT_EVENTS)
    service = GenerationService(model, ModelType.TRANSFORMER, None, 390)
    serving = HttpServing(service, yaml_config)
    try:
        reset_kernel_launch_counts()
        lone = serving.post({"events": prompt.tolist(), "length": GENERATE_EVENTS,
                             "temperature": 0.0})["events"]
        counts = kernel_launch_counts()
        health = serving.health()
    finally:
        serving.close()
        service.close()
    launches["a"] = counts
    print(f"http (a) lone greedy request: launches {counts}; health spec_requests "
          f"{health['spec_requests']}, spec_acceptance_last {health['spec_acceptance_last']}, "
          f"backend {health['backend']}", flush=True)
    if counts["spec"] != 1 or counts["batched"] or counts["single"]:
        raise AssertionError("the lone greedy request did not run on the speculative kernel alone")
    if health["spec_requests"] != 1 or health["spec_acceptance_last"] is None \
            or health["backend"] != device.type:
        raise AssertionError(f"/v1/health: {health}")
    if not np.array_equal(lone, megakernel(prompt, GENERATE_EVENTS)):
        raise AssertionError("the served greedy ids differ from engine='megakernel'")

    # (b) A burst of 16 from 16 threads: ragged prompts of 10, 12 and 16
    # events (two of them MIDI files), 8 greedy and 8 sampled.
    rng = np.random.default_rng(41)
    sampling = [(0.0, 0, 0.0)] * 8 + [(1.0, k, p) for k, p in (
        (0, 0.0), (40, 0.0), (0, 0.9), (20, 0.95), (5, 0.0), (0, 0.8), (100, 0.9), (0, 0.0))]
    payloads, prompts = [], []
    for i, (temperature, top_k, top_p) in enumerate(sampling):
        if i in (0, 8):
            body = midi_prompt_body(yaml_config, 55 + i)
            ids = _prompt_from_json(body, yaml_config, PROMPT_EVENTS)
        else:
            ids = rng.integers(0, 390, (10, 12, 16)[i % 3]).astype(np.int32)
            body = {"events": ids.tolist()}
        payloads.append({**body, "length": GENERATE_EVENTS, "temperature": temperature,
                         "top_k": top_k, "top_p": top_p})
        prompts.append(ids)
    if len({p.tobytes() for p in prompts}) != 16:
        raise AssertionError("the burst's prompts are not distinct")
    service = GenerationService(model, ModelType.TRANSFORMER, None, 390)
    try:
        serving = HttpServing(service, yaml_config)
        spans = {name: KernelSpans(_build.load_library(name))
                 for name in ("decode_generate", "spec_decode")}
        load_library = _build.load_library
        spy = BatchSpy()
        origin = torch.cuda.Event(enable_timing=True)
        try:
            serving.post({"events": prompts[1].tolist(), "length": 64})  # warm-up
            spy.calls.clear()
            _build.load_library = lambda name="decode_generate": (
                spans[name] if name in spans else load_library(name))
            reset_kernel_launch_counts()
            origin.record()  # the worker launches on the same (default) stream
            wall = time.perf_counter()
            responses = serving.post_all(payloads)
            wall = time.perf_counter() - wall
            counts = kernel_launch_counts()
            health = serving.health()
            batch_sizes = service.batch_sizes[1:]
            client_s = sorted(serving.client_s)
        finally:
            _build.load_library = load_library
            spy.restore()
            serving.close()
    finally:
        service.close()
    launches["b"] = counts
    spans = [span for kernel in spans.values() for span in kernel.spans]
    torch.cuda.synchronize()
    busy_ms = sum(begin.elapsed_time(end) for begin, end in spans)
    window_ms = (max(origin.elapsed_time(end) for _, end in spans)
                 - min(origin.elapsed_time(begin) for begin, _ in spans))
    print(f"http (b) burst: 16 x (10/12/16 + {GENERATE_EVENTS}) from 16 threads through "
          f"build_server in {wall:.3f} s (host clock), {16 * GENERATE_EVENTS / wall:.1f} events/s; "
          f"latency p50 {health['latency_p50_s']:.3f} s, p95 {health['latency_p95_s']:.3f} s "
          f"(/v1/health; on the clients' clock, connection included: min {client_s[0]:.3f}, "
          f"median {client_s[8]:.3f}, max {client_s[-1]:.3f} s); batch sizes {batch_sizes}; "
          f"launches {counts}; device busy share "
          f"{busy_ms / window_ms:.5f} (CUDA events around each launch: {busy_ms:.2f} ms of a "
          f"{window_ms:.2f} ms device window) [{card}]", flush=True)
    if counts["batched"] < 1 or max(batch_sizes) < 2:
        raise AssertionError("the burst was not coalesced onto decode_generate")
    worst = 0.0
    for i, (response, ids) in enumerate(zip(responses, prompts)):
        events = np.asarray(response["events"], np.int32)
        plen = len(ids)
        if events.shape != (plen + GENERATE_EVENTS,) or events.min() < 0 \
                or events.max() >= 390 or not np.array_equal(events[:plen], ids):
            raise AssertionError(f"burst request {i}: bad response {events.shape}")
        temperature = sampling[i][0]
        if temperature == 0 and not np.array_equal(events, megakernel(ids, GENERATE_EVENTS)):
            raise AssertionError(f"burst request {i}: greedy ids differ from its lone "
                                 "engine='megakernel' run")
        worst = max(worst, served_token_gap(packed, config, events, plen, temperature,
                                            spy.row_of(ids, temperature)))
        if "midi_base64" in payloads[i]:
            midi = parse_midi(base64.b64decode(response["midi_base64"]))
            if not sum(len(instrument.notes) for instrument in midi.instruments):
                raise AssertionError(f"burst request {i}: the returned MIDI holds no notes")
    print(f"http (b) burst: greedy responses equal their lone engine='megakernel' runs; every "
          f"token, teacher-forced through the plain bf16 forward, within {worst:.3e} of scale "
          f"(limit {BF16_LOGIT_REL_TOL}); both MIDI responses decode", flush=True)

    # (c) The continuous service behind the same handler: ndjson streams.
    rng = np.random.default_rng(43)
    stream_prompts = [rng.integers(0, 390, PROMPT_EVENTS).tolist() for _ in range(4)]
    service = ContinuousGenerationService(model, ModelType.TRANSFORMER, None, 390)
    serving = HttpServing(service, yaml_config)
    try:
        reset_kernel_launch_counts()
        bodies = [{"events": p, "length": GENERATE_EVENTS, "temperature": 0.0}
                  for p in stream_prompts]
        streams = serving.post_all([{**body, "stream": True} for body in bodies])
        blocking = serving.post_all(bodies)
        counts = kernel_launch_counts()
    finally:
        serving.close()
        service.close()
    launches["c"] = counts
    chunks = [len(lines) - 2 for lines in streams]
    print(f"http (c) continuous service behind build_server: 4 streamed greedy requests, "
          f"{chunks} chunks after the prompt echo; launches {counts}", flush=True)
    if counts["segment"] < 1:
        raise AssertionError("the continuous service did not launch decode_segment")
    for lines, response in zip(streams, blocking):
        if lines[-1] != {"done": True} or [t for line in lines[:-1] for t in line["events"]] \
                != response["events"]:
            raise AssertionError("a stream differs from the blocking response")

    # (d) The flagship behind HTTP: the wide kernel.
    rng = np.random.default_rng(47)
    flagship_sampling = [(0.0, 0, 0.0)] * 4 + [(1.0, 0, 0.0), (1.0, 40, 0.0), (1.0, 0, 0.9),
                                                (1.0, 20, 0.95)]
    flagship_prompts = [rng.integers(0, 390, PROMPT_EVENTS).astype(np.int32) for _ in range(8)]
    service = GenerationService(flagship, ModelType.TRANSFORMER, None, 390)
    serving = HttpServing(service, yaml_config)
    spy = BatchSpy()
    try:
        serving.post({"events": flagship_prompts[0].tolist(), "length": 16})  # packs the weights
        spy.calls.clear()
        reset_kernel_launch_counts()
        wall = time.perf_counter()
        responses = serving.post_all([
            {"events": p.tolist(), "length": FLAGSHIP_HTTP_EVENTS, "temperature": t,
             "top_k": k, "top_p": q} for p, (t, k, q) in zip(flagship_prompts, flagship_sampling)])
        wall = time.perf_counter() - wall
        counts = kernel_launch_counts()
        batch_sizes = service.batch_sizes[1:]
    finally:
        spy.restore()
        serving.close()
        service.close()
    launches["d"] = counts
    print(f"http (d) flagship: 8 x ({PROMPT_EVENTS} + {FLAGSHIP_HTTP_EVENTS}) from 8 threads in "
          f"{wall:.3f} s (host clock), {8 * FLAGSHIP_HTTP_EVENTS / wall:.1f} events/s; batch "
          f"sizes {batch_sizes}; launches {counts} [{card}]", flush=True)
    if counts["wide"] < 1 or counts["batched"] or counts["single"] or counts["spec"]:
        raise AssertionError("the flagship behind HTTP did not run on decode_wide alone")
    worst = 0.0
    for response, ids, (temperature, _, _) in zip(responses, flagship_prompts, flagship_sampling):
        events = np.asarray(response["events"], np.int32)
        if events.shape != (PROMPT_EVENTS + FLAGSHIP_HTTP_EVENTS,) or events.max() >= 390 \
                or events.min() < 0 or not np.array_equal(events[:PROMPT_EVENTS], ids):
            raise AssertionError(f"flagship response: bad ids {events.shape}")
        worst = max(worst, served_token_gap(flagship_packed, flagship.config, events,
                                            PROMPT_EVENTS, temperature,
                                            spy.row_of(ids, temperature)))
    print(f"http (d) flagship: every token, teacher-forced through the plain bf16 forward, "
          f"within {worst:.3e} of scale (limit {BF16_LOGIT_REL_TOL})", flush=True)

    # (e) The admission prefill and the prefix cache on the card, float32.
    case = admission_prefill_case(model, device)
    print(f"http (e) continuous admission, float32, 100-event prompts: token by token, with "
          f"the prefill forward and from the prefix cache, identical greedy ids; prefix cache "
          f"hits {case['stats']['prefix_cache_hits']}, misses "
          f"{case['stats']['prefix_cache_misses']}", flush=True)
    total = {name: sum(counts[name] for counts in launches.values())
             for name in launches["a"]}
    print(f"phase 10 took {time.perf_counter() - start:.1f} s (host clock); launches {total}",
          flush=True)
    return total


CLI_FILES, CLI_NOTES = 24, 400  # phase 11's corpus: MIDI files of random notes
CLI_SEED = 11
CLI_TIMEOUT = 300  # seconds: the bound on every wait for a CLI subprocess


def cli_corpus(raw: Path) -> None:
    """``CLI_FILES`` MIDI files of ``CLI_NOTES`` random notes each (numpy
    seed ``CLI_SEED``), written by the port's ``NoteSequence.to_midi``."""
    from composer_tpu_torch.midi.events import Note, NoteSequence

    rng = np.random.default_rng(CLI_SEED)
    raw.mkdir(parents=True)
    for index in range(CLI_FILES):
        starts = np.cumsum(rng.integers(0, 400, CLI_NOTES))
        lengths = rng.integers(50, 1500, CLI_NOTES)
        pitches, velocities = rng.integers(36, 96, CLI_NOTES), rng.integers(20, 127, CLI_NOTES)
        notes = [Note(float(s), float(s + d), int(p), int(v))
                 for s, d, p, v in zip(starts, lengths, pitches, velocities)]
        NoteSequence(notes).to_midi(str(raw / f"piece{index:02d}.mid"))


class Spans:
    """Host-clock seconds spent inside some functions while a command runs
    (a CUDA synchronize after each call), by patching them for the duration."""

    def __init__(self, targets):
        self.targets, self.seconds, self.calls = targets, {}, {}

    def __enter__(self):
        self.saved = []
        for name, (owner, attribute) in self.targets.items():
            real = getattr(owner, attribute)
            self.saved.append((owner, attribute, real))
            self.seconds[name], self.calls[name] = [], 0

            def timed(*args, _real=real, _name=name, **kwargs):
                torch.cuda.synchronize()
                start = time.perf_counter()
                result = _real(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds[_name].append(time.perf_counter() - start)
                return result

            setattr(owner, attribute, timed)
        return self

    def __exit__(self, *exc):
        for owner, attribute, real in self.saved:
            setattr(owner, attribute, real)


def cli_command(args, spans=None) -> tuple:
    """One in-process command of the port's CLI (``cli.main`` as the
    ``__main__`` guard runs it, errors propagating): ``(wall seconds, the
    kernels' launches during it)``."""
    from composer_tpu_torch import cli

    reset_kernel_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with spans if spans is not None else contextlib.nullcontext():
        code = cli.cli.main([str(a) for a in args], standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if code not in (None, 0):
        raise AssertionError(f"cli {args[:3]} exited {code}")
    return wall, kernel_launch_counts()


def run_cli_process(args) -> None:
    """``python -m composer_tpu_torch.cli <args>`` in a process of its own,
    from the repository's root, bounded by ``CLI_TIMEOUT``."""
    result = subprocess.run([sys.executable, "-m", "composer_tpu_torch.cli", *map(str, args)],
                            cwd=Path(__file__).resolve().parent, timeout=CLI_TIMEOUT,
                            capture_output=True, text=True)
    if result.returncode != 0:
        raise AssertionError(f"cli {args[:4]} exited {result.returncode}: "
                             f"{result.stderr[-2000:]}")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_json(url: str, payload=None):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    request = urllib.request.Request(url, data=data,
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=CLI_TIMEOUT) as response:
        return json.loads(response.read())


def serve_subprocess(args, log: Path, requests) -> tuple:
    """``python -m composer_tpu_torch.cli ... serve`` as a user starts it:
    waits (bounded) for ``/v1/health``, posts each list of ``requests`` from
    its own threads at once, reads the health, then stops the server with
    SIGINT. Returns ``(seconds to come up, responses by list, health, the
    kernels' launches that the server logged at shutdown)``."""
    import signal
    import urllib.error

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    start = time.perf_counter()
    with open(log, "wb") as sink:
        process = subprocess.Popen(
            [sys.executable, "-m", "composer_tpu_torch.cli", *map(str, args), "--port",
             str(port)], cwd=Path(__file__).resolve().parent, stdout=sink,
            stderr=subprocess.STDOUT, env={**os.environ, "PYTHONUNBUFFERED": "1"})
    try:
        while True:
            if process.poll() is not None:
                raise AssertionError(f"serve exited {process.returncode}: {log.read_text()}")
            if time.perf_counter() - start > CLI_TIMEOUT:
                raise AssertionError(f"serve did not come up: {log.read_text()[-2000:]}")
            try:
                http_json(base + "/v1/health")
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.2)
        up_s = time.perf_counter() - start
        responses = []
        for payloads in requests:
            results = [None] * len(payloads)

            def call(i, payloads=payloads, results=results):
                try:
                    results[i] = http_json(base + "/v1/generate", payloads[i])
                except Exception as error:  # re-raised below, on this thread
                    results[i] = error

            threads = [threading.Thread(target=call, args=(i,), daemon=True)
                       for i in range(len(payloads))]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=CLI_TIMEOUT)
            for result in results:
                if result is None or isinstance(result, Exception):
                    raise AssertionError(f"a request to serve failed: {result!r}")
            responses.append(results)
        health = http_json(base + "/v1/health")
        process.send_signal(signal.SIGINT)
        code = process.wait(timeout=CLI_TIMEOUT)
    finally:
        if process.poll() is None:
            process.kill()
            process.wait(timeout=60)
    text = log.read_text()
    if code != 0:
        raise AssertionError(f"serve exited {code} after SIGINT: {text[-2000:]}")
    marker = "Kernel launches: "
    lines = [line for line in text.splitlines() if marker in line]
    if not lines:
        raise AssertionError(f"serve logged no launches: {text[-2000:]}")
    return up_s, responses, health, json.loads(lines[-1].split(marker, 1)[1])


def native_codec_path(raw: Path, tmp: Path, seed, card: str, record) -> None:
    """The native codec must be loaded and parse every corpus file into the
    Python parser's arrays; ``preprocess`` in process (one worker, no
    augmentation) with it and with the Python paths writes identical trees.
    Both times are host time only."""
    from composer_tpu_torch import native
    from composer_tpu_torch.midi import midi_io
    from composer_tpu_torch.native import loader as native_loader

    if not native.available():
        raise AssertionError("the native codec library did not load")
    for path in sorted(raw.glob("*.mid")):
        data = path.read_bytes()
        ours = native.parse_midi_arrays(data)
        plain = midi_io._parsed_arrays_from_midifile(midi_io.parse_midi(data))
        if ours is None or ours.keys() != plain.keys() or any(
                ours[key].dtype != plain[key].dtype or not np.array_equal(ours[key], plain[key])
                for key in plain):
            raise AssertionError(f"native parse of {path.name} differs from the Python parser's")
    trees, walls = {}, {}
    for name in ("native", "python"):
        out = tmp / f"processed_{name}"
        if name == "python":
            native_loader._LIBRARY = False  # what a failed build leaves: the Python paths
        try:
            walls[name], _ = cli_command([*seed, "preprocess", "transformer", raw, out, "-c",
                                          tmp / "config.yml", "-w", 1, "--no-transform",
                                          "--no-metadata"])
        finally:
            native_loader._LIBRARY = None
        trees[name] = {str(f.relative_to(out)): f.read_bytes()
                       for f in sorted(out.rglob("*.data"))}
    record("preprocess -w 1 --no-transform (native)", walls["native"], {})
    if not native.available() or trees["native"] != trees["python"] or not trees["native"]:
        raise AssertionError("preprocess with the native codec and with the Python paths "
                             "wrote different .data trees")
    print(f"cli preprocess, native codec: {CLI_FILES} MIDI files parsed by the native parser "
          f"into the Python parser's arrays; preprocess -w 1 --no-transform in process "
          f"{walls['native']:.3f} s with the native codec, {walls['python']:.3f} s on the "
          f"Python paths ({walls['python'] / walls['native']:.2f}x; host only, no device "
          f"work), identical .data trees ({len(trees['native'])} files) [{card}]", flush=True)


def tfrecord_path(processed: Path, tmp: Path, logdir: Path, config, seed, card: str,
                  record) -> None:
    """``export-dataset`` of ``processed/``, read back against ``get_dataset``
    on the directory; ``evaluate`` on the ``.tfrecord`` (flash forwards only)
    and ``train -e 1`` from it (8 launches a step each way)."""
    from composer_tpu_torch import cli as cli_module
    from composer_tpu_torch.data import tfrecord
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.train import trainer as trainer_module

    corpus = tmp / "corpus.tfrecord"
    wall, counts = cli_command([*seed, "export-dataset", "transformer", processed, corpus, "-c",
                                tmp / "config.yml"])
    record("export-dataset", wall, counts)
    header, batches = tfrecord.load_tfrecord_dataset(corpus)
    np.random.seed(CLI_SEED)  # the file order the command drew under --seed
    expected = list(cli_module.get_dataset(ModelType.TRANSFORMER, processed, config,
                                           shuffle_dataset=False, show_progress_bar=False))
    same = len(batches) == len(expected) > 0 and all(
        np.array_equal(x, x0) and np.array_equal(y, y0)
        for (x, y), (x0, y0) in zip(batches, expected))
    print(f"cli export-dataset: {wall:.3f} s, {corpus.stat().st_size} bytes, {len(batches)} "
          f"batches of {header['batch_size']} x {header['window_size']}, equal to get_dataset's "
          f"on the directory: {same} [{card}]", flush=True)
    if not same or any(counts.values()):
        raise AssertionError(f"cli export-dataset: batches equal {same}, launches {counts}")

    scores = []
    evaluate = trainer_module.Trainer.evaluate
    trainer_module.Trainer.evaluate = \
        lambda self, *a, **k: scores.append(evaluate(self, *a, **k)) or scores[-1]
    try:
        wall, counts = cli_command([*seed, "evaluate", "transformer", corpus, logdir])
    finally:
        trainer_module.Trainer.evaluate = evaluate
    record("evaluate .tfrecord", wall, counts)
    print(f"cli evaluate on the .tfrecord: {wall:.3f} s, loss {scores[0]['loss']:.6f}, accuracy "
          f"{scores[0]['accuracy']:.6f} over {len(batches)} batches; launches {counts} [{card}]",
          flush=True)
    if counts["flash_fwd mma 16"] != 8 * len(batches) or counts["flash_bwd mma 16"] \
            or not np.isfinite(scores[0]["loss"]):
        raise AssertionError(f"cli evaluate .tfrecord: launches {counts}, metrics {scores}")

    spans = Spans({"step": (trainer_module.Trainer, "train_step")})
    wall, counts = cli_command([*seed, "train", "transformer", corpus, "-c", tmp / "config.yml",
                                "--logdir", tmp / "logs_tfrecord", "-e", 1, "--save-freq-mode",
                                "epoch", "--no-show-progress-bar"], spans)
    record("train .tfrecord", wall, counts)
    steps = spans.seconds["step"]
    logdir = next((tmp / "logs_tfrecord").glob("transformer-*"))
    rows = [json.loads(line) for line in
            (logdir / "train" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in sorted(rows, key=lambda r: r["step"]) if r["name"] == "loss"]
    print(f"cli train from the .tfrecord: {wall:.3f} s, {len(steps)} steps, step "
          f"{float(np.mean(steps[1:])) * 1e3:.2f} ms (steps 2-, host clock after synchronize), "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {counts} [{card}]", flush=True)
    expected = (8 * len(steps),) * 2
    if len(steps) != len(batches) or not np.all(np.isfinite(losses)) \
            or (counts["flash_fwd mma 16"], counts["flash_bwd mma 16"]) != expected:
        raise AssertionError(f"cli train .tfrecord: {len(steps)} steps, launches {counts}, "
                             f"wanted {expected}; losses {losses}")


def printed_by(args) -> tuple:
    """``cli_command`` with the command's standard output captured:
    ``(wall seconds, launches, its lines)``."""
    import io

    sink = io.StringIO()
    with contextlib.redirect_stdout(sink):
        wall, counts = cli_command(args)
    return wall, counts, sink.getvalue().splitlines()


def info_commands(processed: Path, tmp: Path, seed, card: str, record) -> None:
    """``summary`` and ``visualize-training`` at the phase's config."""
    from composer_tpu_torch.config import get as get_config
    from composer_tpu_torch.models import ModelType, create_model

    wall, counts, lines = printed_by([*seed, "summary", "transformer", "-c", tmp / "config.yml"])
    record("summary", wall, counts)
    model, _ = create_model(ModelType.TRANSFORMER, get_config(tmp / "config.yml"), device="cpu")
    total = sum(p.numel() for p in model.parameters())
    print(f"cli summary: {wall:.3f} s, {len(lines)} lines; {lines[-2]}; {lines[-1]} [{card}]",
          flush=True)
    if lines[-1] != "Event vocabulary size: 390" \
            or not lines[-2].startswith(f"Total parameters: {total:,} "):
        raise AssertionError(f"cli summary printed {lines[-2:]}, wanted {total:,} parameters")

    wall, counts, lines = printed_by([*seed, "visualize-training", "transformer", processed,
                                      "-c", tmp / "config.yml", "--steps", 8])
    record("visualize-training", wall, counts)
    print(f"cli visualize-training: {wall:.3f} s; {lines[1][:100]} ... [{card}]", flush=True)
    if len(lines) != 6 + 3 * 8 or lines[-3] != "Step 8" or any(counts.values()):
        raise AssertionError(f"cli visualize-training printed {lines[:3]} ... {lines[-3:]}")


def synthesize_command(midi: Path, seed, card: str, record) -> None:
    """``synthesize --renderer builtin`` of a generated MIDI file."""
    import wave

    wall, counts = cli_command([*seed, "synthesize", midi, "--renderer", "builtin"])
    record("synthesize", wall, counts)
    with wave.open(str(midi.with_suffix(".wav"))) as handle:
        frames, rate = handle.getnframes(), handle.getframerate()
        pcm = np.frombuffer(handle.readframes(frames), "<i2")
    peak = int(np.abs(pcm).max()) if pcm.size else 0
    print(f"cli synthesize --renderer builtin: {wall:.3f} s (host only) for "
          f"{frames / rate:.2f} s of audio at {rate} Hz, peak {peak} [{card}]", flush=True)
    if peak < 1000 or frames < rate:
        raise AssertionError(f"cli synthesize wrote {frames} frames, peak {peak}")


PROFILE_KERNELS = ("flash_forward_mma_kernel", "flash_backward_mma_kernel",
                   "decode_generate_kernel")


def profile_command(tmp: Path, seed, card: str, record) -> None:
    """``profile --steps 2 --decode-length 64`` with the phase's flash config:
    a warm-up step and decode, then two traced steps and a traced decode;
    the Chrome trace must hold the hand-written kernels' launches by name."""
    out = tmp / "profile"
    wall, counts = cli_command([*seed, "profile", "transformer", out, "-c", tmp / "config.yml",
                                "--steps", 2, "--decode-length", 64])
    record("profile", wall, counts)
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {name: sum(1 for e in kernels if name in str(e.get("name", "")))
               for name in PROFILE_KERNELS}
    decode = [e for e in events if e.get("name") == "decode"]
    print(f"cli profile --steps 2 --decode-length 64: {wall:.3f} s, trace "
          f"{(out / 'trace.json').stat().st_size} bytes, {len(kernels)} kernel events, by name "
          f"{by_name}, decode span {len(decode)}; launches {counts} [{card}]", flush=True)
    if counts["flash_bwd mma 16"] != 8 * 3 or counts["flash_fwd mma 16"] < 8 * 3 \
            or counts["single"] != 2 or counts["batched"] or counts["spec"] \
            or not all(by_name.values()) or not decode:
        raise AssertionError(f"cli profile: launches {counts}, trace kernels {by_name}, "
                             f"decode spans {len(decode)}")


def cli_path(device, card: str) -> dict:
    """Phase 11: the port's CLI on the card, at the default model's full
    width. Returns the launches of each kernel over the phase's commands
    (the in-process ones and the two servers)."""
    import yaml

    from composer_tpu_torch import cli as cli_module
    from composer_tpu_torch.config import get as get_config
    from composer_tpu_torch.midi.events import EventSequence, NoteSequence
    from composer_tpu_torch.models import ModelType, create_model
    from composer_tpu_torch.train import generate as gen
    from composer_tpu_torch.train import trainer as trainer_module

    phase_start = time.perf_counter()
    totals, walls = {}, {}

    def record(name, wall, counts):
        walls[name] = wall
        for key, count in counts.items():
            totals[key] = totals.get(key, 0) + count

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        raw, processed, logs = tmp / "raw", tmp / "processed", tmp / "logs"
        cli_corpus(raw)
        seed = ("--seed", CLI_SEED)

        record("make-config", *cli_command([*seed, "make-config", tmp / "config.yml"]))
        source = yaml.safe_load((tmp / "config.yml").read_text())
        source["transformer"]["model"]["use_pallas_attention"] = True
        source["transformer"]["train"]["batch_size"] = TRAIN_BATCH
        (tmp / "config.yml").write_text(yaml.safe_dump(source))
        config = get_config(tmp / "config.yml")

        # preprocess launches no kernel: it runs as users run it, a process of
        # its own, whose workers import neither torch nor this script.
        start = time.perf_counter()
        run_cli_process([*seed, "preprocess", "transformer", raw, processed, "-c",
                         tmp / "config.yml", "-w", 8])
        record("preprocess", time.perf_counter() - start, {})
        train_files = len(list((processed / "train").glob("*.data")))
        test_files = len(list((processed / "test").glob("*.data")))
        train_midi = int(CLI_FILES * 0.7)  # preprocess's default split, 30% to test
        if (train_files, test_files) != (train_midi * 10, CLI_FILES - train_midi):
            # each train file and its 9 transposed or stretched copies
            raise AssertionError(f"preprocess wrote {train_files} train / {test_files} test "
                                 f"files, wanted {train_midi * 10} / {CLI_FILES - train_midi}")
        native_codec_path(raw, tmp, seed, card, record)

        spans = Spans({"step": (trainer_module.Trainer, "train_step"),
                       "create": (cli_module, "create_model"),
                       "load": (cli_module, "get_dataset")})
        wall, train_counts = cli_command(
            [*seed, "train", "transformer", processed, "-c", tmp / "config.yml", "--logdir",
             logs, "-e", 1, "--save-freq-mode", "epoch", "--no-show-progress-bar"], spans)
        record("train", wall, train_counts)
        logdir = next(logs.glob("transformer-*"))
        steps = spans.seconds["step"]
        rows = [json.loads(line) for line in
                (logdir / "train" / "metrics.jsonl").read_text().splitlines()]
        losses = [r["value"] for r in sorted(rows, key=lambda r: r["step"])
                  if r["name"] == "loss"]
        scalar = [r["value"] for r in rows if r["name"] == "events_per_second"][0]
        step_ms = float(np.mean(steps[1:])) * 1e3
        print(f"cli train: {train_files} train / {test_files} test .data files from "
              f"{CLI_FILES} MIDI files; {len(steps)} steps of {TRAIN_BATCH} x {TRAIN_WINDOW}, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; step {step_ms:.2f} ms (steps 2-, "
              f"host clock after synchronize; min {min(steps[1:]) * 1e3:.2f}, max "
              f"{max(steps[1:]) * 1e3:.2f}), {TRAIN_BATCH * TRAIN_WINDOW / (step_ms / 1e3):.1f} "
              f"train events/s; step 1 {steps[0] * 1e3:.2f} ms; the trainer's "
              f"events_per_second scalar {scalar:.1f}; the command {wall:.3f} s = model "
              f"{spans.seconds['create'][0]:.3f} s + data {spans.seconds['load'][0]:.3f} s + "
              f"steps {sum(steps):.3f} s + the rest (config, init, checkpoint) "
              f"{wall - spans.seconds['create'][0] - spans.seconds['load'][0] - sum(steps):.3f}"
              f" s; launches {train_counts} [{card}]", flush=True)
        expected = (8 * len(steps),) * 2
        if (train_counts["flash_fwd mma 16"], train_counts["flash_bwd mma 16"]) != expected \
                or not np.all(np.isfinite(losses)) or len(losses) != len(steps):
            raise AssertionError(f"cli train: launches {train_counts}, wanted {expected} "
                                 f"each way; losses {losses}")

        scores = []
        evaluate = trainer_module.Trainer.evaluate
        trainer_module.Trainer.evaluate = \
            lambda self, *a, **k: scores.append(evaluate(self, *a, **k)) or scores[-1]
        try:
            wall, eval_counts = cli_command([*seed, "evaluate", "transformer", processed, logdir])
        finally:
            trainer_module.Trainer.evaluate = evaluate
        record("evaluate", wall, eval_counts)
        print(f"cli evaluate: loss {scores[0]['loss']:.6f}, accuracy "
              f"{scores[0]['accuracy']:.6f}, perplexity {scores[0]['perplexity']:.3f}; "
              f"launches {eval_counts} [{card}]", flush=True)
        if eval_counts["flash_fwd mma 16"] < 1 or eval_counts["flash_bwd mma 16"] \
                or not np.isfinite(scores[0]["loss"]):
            raise AssertionError(f"cli evaluate: launches {eval_counts}, metrics {scores}")
        tfrecord_path(processed, tmp, logdir, config, seed, card, record)
        info_commands(processed, tmp, seed, card, record)

        # The prompt as generate encodes it: the first 10 events of a MIDI file.
        prompt_file = raw / "piece00.mid"
        prompt = NoteSequence.from_midi(str(prompt_file)).trim_start().to_event_sequence(
            config.dataset.time_step_increment, config.dataset.max_time_steps,
            config.dataset.velocity_bins).to_ids().astype(np.int32)[:PROMPT_EVENTS]
        model, _ = create_model(ModelType.TRANSFORMER, config, device=device)
        restored = trainer_module.Trainer(model, ModelType.TRANSFORMER, 1e-3, device=device)
        restored.restore(logdir, TRAIN_BATCH, TRAIN_WINDOW)
        reference = {}
        for name, temperature in (("sampled", 1.0), ("greedy", 0.0)):
            out = tmp / f"{name}.mid"
            kernel = "megakernel_generate_batched" if temperature else "speculative_generate"
            spans = Spans({"create": (cli_module, "create_model"),
                           "restore": (trainer_module.Trainer, "restore"),
                           "decode": (gen, "generate_ids"),
                           "pack": (gen.TransformerDecoder, "__init__"),
                           "kernel": (gen, kernel)})
            wall, counts = cli_command(
                [*seed, "generate", "transformer", logdir, out, "-p", prompt_file,
                 "--prompt-length", PROMPT_EVENTS, "-l", GENERATE_EVENTS, "--temperature",
                 temperature], spans)
            record(f"generate {name}", wall, counts)
            ids = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompt,
                                   length=GENERATE_EVENTS, temperature=temperature,
                                   seed=CLI_SEED, engine="auto")
            reference[name] = ids
            path = tmp / f"{name}_in_process.mid"
            EventSequence.from_ids(ids, config.dataset.time_step_increment,
                                   config.dataset.max_time_steps,
                                   config.dataset.velocity_bins).to_note_sequence().to_midi(
                str(path))
            same = out.read_bytes() == path.read_bytes()
            took = {key: sum(values) for key, values in spans.seconds.items()}
            print(f"cli generate {name}: {wall:.3f} s in process = model {took['create']:.3f} s"
                  f" + restore {took['restore']:.3f} s + generate_ids {took['decode']:.3f} s "
                  f"({GENERATE_EVENTS / took['decode']:.1f} events/s; of it packing the weights "
                  f"{took['pack']:.3f} s, {kernel} {took['kernel']:.3f} s) + the rest "
                  f"{wall - took['create'] - took['restore'] - took['decode']:.3f} s; MIDI "
                  f"identical to generate_ids on the restored weights: {same}; launches "
                  f"{counts} [{card}]", flush=True)
            wanted = ("single", "spec") if name == "sampled" else ("spec", "single")
            if not same or counts[wanted[0]] != 1 or counts[wanted[1]] or counts["batched"]:
                raise AssertionError(f"cli generate {name}: identical {same}, launches {counts}")

        synthesize_command(tmp / "sampled.mid", seed, card, record)

        # The same sampled command as a user runs it: a fresh process, whose
        # start-up (interpreter, torch, the CUDA context, the kernels' load)
        # the in-process wall does not hold.
        start = time.perf_counter()
        run_cli_process([*seed, "generate", "transformer", logdir, tmp / "fresh.mid", "-p",
                         prompt_file, "--prompt-length", PROMPT_EVENTS, "-l", GENERATE_EVENTS])
        fresh_s = time.perf_counter() - start
        same = (tmp / "fresh.mid").read_bytes() == (tmp / "sampled.mid").read_bytes()
        print(f"cli generate sampled as a fresh process: {fresh_s:.3f} s wall, "
              f"{fresh_s - walls['generate sampled']:.3f} s more than in process (start-up); "
              f"MIDI identical: {same} [{card}]", flush=True)
        if not same:
            raise AssertionError("a fresh generate process wrote other MIDI")

        body = {"events": prompt.tolist(), "length": GENERATE_EVENTS}
        up_s, responses, health, counts = serve_subprocess(
            [*seed, "serve", "transformer", logdir], tmp / "serve.log",
            [[{**body, "temperature": 0.0}], [{**body, "temperature": 1.0}] * 8])
        record("serve", up_s, counts)
        lone = np.asarray(responses[0][0]["events"])
        burst = [np.asarray(r["events"]) for r in responses[1]]
        print(f"cli serve: up in {up_s:.3f} s; lone greedy request equal to the in-process "
              f"greedy run: {np.array_equal(lone, reference['greedy'])}; health spec_requests "
              f"{health['spec_requests']}, spec_acceptance_last "
              f"{health['spec_acceptance_last']}; launches {counts} [{card}]", flush=True)
        if not np.array_equal(lone, reference["greedy"]) or health["spec_requests"] != 1 \
                or counts["spec"] != 1 or counts["batched"] < 1:
            raise AssertionError(f"cli serve: health {health}, launches {counts}")
        for events in burst:
            if events.shape != (PROMPT_EVENTS + GENERATE_EVENTS,) or events.min() < 0 \
                    or events.max() >= 390 or not np.array_equal(events[:PROMPT_EVENTS], prompt):
                raise AssertionError(f"cli serve: a bad sampled response {events.shape}")

        up_s, responses, health, counts = serve_subprocess(
            [*seed, "serve", "transformer", logdir, "--continuous"],
            tmp / "serve_continuous.log", [[{**body, "temperature": 0.0}]])
        record("serve --continuous", up_s, counts)
        events = np.asarray(responses[0][0]["events"])
        agree = float(np.mean(events[PROMPT_EVENTS:] == reference["greedy"][PROMPT_EVENTS:]))
        print(f"cli serve --continuous: up in {up_s:.3f} s; one greedy request, agreement with "
              f"the in-process greedy run {agree:.4f} (bf16); launches {counts} [{card}]",
              flush=True)
        if counts["segment"] < 1 or events.shape != (PROMPT_EVENTS + GENERATE_EVENTS,) \
                or events.min() < 0 or events.max() >= 390:
            raise AssertionError(f"cli serve --continuous: launches {counts}, {events.shape}")

        profile_command(tmp, seed, card, record)

    print("cli wall times (s; serve: until /v1/health answers): " + ", ".join(
        f"{name} {seconds:.3f}" for name, seconds in walls.items()) + f" [{card}]", flush=True)
    print(f"phase 11 took {time.perf_counter() - phase_start:.1f} s (host clock); launches "
          f"{totals}", flush=True)
    return totals


RNN_TRAIN_STEPS = 8  # phase 12: bf16 steps on one fixed batch
RNN_DECODE_BATCH, RNN_DECODE_EVENTS = 8, 1024  # composer_tpu/bench.py:397's decode shape
RNN_F32_TOL = 1e-4  # f32 logits, card against CPU, of their scale: other summation orders


def rnn_path(device, card: str, yaml_config) -> dict:
    """Phase 12: MusicRNN at the default config's widths (vocab 390, embed
    256, 3 LSTM layers of 512, dropout 0.3, BatchNorm; batch 64 x window
    200, bf16 on the card), through the entry points a user calls. No TPU
    kernel lies on this path (the JAX package's LSTM is an XLA scan), so no
    kernel's launch count moves: the LSTM is cuDNN's (``torch.lstm``)."""
    from composer_tpu_torch.data import WindowDataset
    from composer_tpu_torch.models import ModelType, create_model, get_learning_rate
    from composer_tpu_torch.models.music_rnn import MusicRNN
    from composer_tpu_torch.train.generate import generate_ids
    from composer_tpu_torch.train.trainer import Trainer

    model, vocab = create_model(ModelType.MUSIC_RNN, yaml_config, device=device)
    config = model.config
    section = yaml_config.music_rnn
    batch, window = int(section.train.batch_size), int(section.model.window_size)
    if (config.dtype, batch, window, config.layer_sizes) != (torch.bfloat16, 64, 200,
                                                             (512, 512, 512)):
        raise AssertionError(f"not the default MusicRNN: {config}, {batch} x {window}")
    trainer = Trainer(model, ModelType.MUSIC_RNN, get_learning_rate(ModelType.MUSIC_RNN,
                                                                    yaml_config),
                      seed=0, device=device)
    state = trainer.init_state(batch, window)
    block = training_corpus(yaml_config, batch * (window + 1))[:batch * (window + 1)]
    # The same batch every step: the loss must fall on it.
    fixed = WindowDataset(np.tile(block, RNN_TRAIN_STEPS), batch, window, shuffle=False)
    with tempfile.TemporaryDirectory() as tmp:
        state, step_seconds, losses, _ = timed_train(trainer, state, fixed, tmp)
    mean_step = float(np.mean(step_seconds[1:]))
    print(f"MusicRNN train bf16 {batch} x {window}: losses {[round(x, 4) for x in losses]}; "
          f"step 1 {step_seconds[0] * 1e3:.2f} ms, then {mean_step * 1e3:.2f} ms (steps "
          f"2-{RNN_TRAIN_STEPS}), {batch * window / mean_step:.1f} train events/s [{card}]",
          flush=True)
    if len(losses) != RNN_TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"bad MusicRNN losses: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the MusicRNN loss did not fall on a fixed batch: {losses}")
    stats = [norm.running_var for norm in model.batch_norms]
    if any(s.device != device or bool((s == 1).all()) for s in stats):
        raise AssertionError("the BatchNorm statistics did not move on the card")
    profile_steps(trainer, state, fixed, card, 3)

    corpus = training_corpus(yaml_config, 4 * batch * (window + 1) + 1)
    held_out = WindowDataset(corpus[-4 * batch * (window + 1):], batch, window, shuffle=False)
    torch.cuda.synchronize()
    start = time.perf_counter()
    scores = trainer.evaluate(held_out, state)
    evaluate_s = time.perf_counter() - start
    print(f"MusicRNN evaluate over {len(held_out)} batches: loss {scores['loss']:.4f}, "
          f"accuracy {scores['accuracy']:.4f} in {evaluate_s:.3f} s [{card}]", flush=True)
    if not np.isfinite(scores["loss"]):
        raise AssertionError(f"bad MusicRNN evaluation: {scores}")

    prompts = np.tile(encoded_prompt(yaml_config, PROMPT_EVENTS), (RNN_DECODE_BATCH, 1))
    generate_ids(model, ModelType.MUSIC_RNN, None, prompts, length=16)  # warm-up
    window_events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    start = time.perf_counter()
    window_events[0].record()
    ids = generate_ids(model, ModelType.MUSIC_RNN, None, prompts, length=RNN_DECODE_EVENTS,
                       temperature=1.0, seed=1)
    window_events[1].record()
    decode_s = time.perf_counter() - start
    events = RNN_DECODE_BATCH * RNN_DECODE_EVENTS
    print(f"MusicRNN generate_ids bf16 {RNN_DECODE_BATCH} x ({PROMPT_EVENTS} + "
          f"{RNN_DECODE_EVENTS}): {decode_s:.3f} s, {events / decode_s:.1f} events/s, device "
          f"window {window_events[0].elapsed_time(window_events[1]):.1f} ms [{card}]",
          flush=True)
    if ids.shape != (RNN_DECODE_BATCH, PROMPT_EVENTS + RNN_DECODE_EVENTS) or ids.min() < 0 \
            or ids.max() >= vocab:
        raise AssertionError(f"bad MusicRNN ids: shape {ids.shape}")

    # The trained weights in float32 on the card against the same on the
    # CPU: logits, and greedy decode (equal ids, or every card token within
    # the bf16 rule of its row's maximum, teacher-forced on the CPU).
    f32 = dataclasses.replace(config, dtype=torch.float32)
    weights = {name: t.detach().cpu() for name, t in model.state_dict().items()}
    card_model, host_model = MusicRNN(f32), MusicRNN(f32)
    for m in (card_model, host_model):
        m.load_state_dict(weights)
    card_model.to(device)
    tokens = torch.as_tensor(block[:4 * window].reshape(4, window)).long()
    with torch.no_grad():
        host_logits, _ = host_model(tokens)
        card_logits, _ = card_model(tokens.to(device))
        bf16_logits, _ = model(tokens.to(device))
    scale = float(host_logits.abs().max())
    f32_err = float((card_logits.cpu() - host_logits).abs().max())
    bf16_err = float((bf16_logits.float().cpu() - host_logits).abs().max())
    greedy = {}
    for name, m in (("card", card_model), ("cpu", host_model)):
        greedy[name] = generate_ids(m, ModelType.MUSIC_RNN, None, prompts[:4], length=246,
                                    temperature=0.0)
    same = bool(np.array_equal(greedy["card"], greedy["cpu"]))
    gap = 0.0
    if not same:
        with torch.no_grad():
            forced, _ = host_model(torch.as_tensor(greedy["card"][:, :-1]).long())
        step_logits = forced[:, PROMPT_EVENTS - 1:]
        picked = step_logits.gather(-1, torch.as_tensor(
            greedy["card"][:, PROMPT_EVENTS:]).long()[..., None])[..., 0]
        gap = float((step_logits.max(-1).values - picked).max()) / float(
            step_logits.abs().max())
    print(f"MusicRNN f32 card against CPU (same weights, 4 x {window}): logits max_abs_err "
          f"{f32_err:.3e} (scale {scale:.3f}); bf16 card against f32 CPU {bf16_err:.3e}; greedy "
          f"4 x (10 + 246) ids equal={same}, worst token gap {gap:.4f} of scale", flush=True)
    if f32_err > RNN_F32_TOL * scale:
        raise AssertionError(f"MusicRNN f32 logits differ by {f32_err} > {RNN_F32_TOL} x {scale}")
    if bf16_err > BF16_LOGIT_REL_TOL * scale:
        raise AssertionError(f"MusicRNN bf16 logits differ by {bf16_err} > "
                             f"{BF16_LOGIT_REL_TOL} x {scale}")
    if gap > BF16_LOGIT_REL_TOL:
        raise AssertionError(f"MusicRNN greedy card token {gap} of scale below its row's max")
    return {"step_ms": mean_step * 1e3, "decode_s": decode_s, "loss": scores["loss"]}


MESH_F32_STEPS, MESH_BF16_STEPS = 3, 5  # phase 13: steps on each mesh
MESH_F32_LOSS_RTOL = 1e-4  # f32 losses, mesh against one process: other summation orders
MESH_BF16_LOSS_RTOL = 2e-2  # bf16 losses: the bf16 rule
MESH_JOIN_S = 300  # the bound on the ranks' run; the phase itself aims at under 60 s
MESH_SERVE_LENGTH = 30  # events a phase-13 request asks for
# Its 4 prompts' lengths: ragged, in one power-of-two bucket (one batch).
MESH_SERVE_PLENS = (10, 9, 12, 14)


def mesh_config():
    """Phase 13's model: the default config (vocab 390, embed 256, 8 layers
    x 16 heads, window 1024) with relative attention, the flash kernels and
    dropout 0."""
    from composer_tpu_torch.config import get_default

    config = get_default()
    section = config.transformer.model
    section.use_pallas_attention = True
    section.use_relative_attention = True
    section.attention_dropout_rate = 0.0
    section.residual_dropout_rate = 0.0
    return config


def mesh_model(config, dtype, stddev=None):
    """The full model on the CPU (a mesh Trainer or service keeps its slice
    on the card)."""
    from composer_tpu_torch.models import ModelType, create_model

    if stddev is not None:
        config = mesh_config()
        config.transformer.model.initializer_stddev = stddev
    return create_model(ModelType.TRANSFORMER, config, device="cpu", dtype=dtype)[0]


def mesh_steps(trainer, state, batches, timed_from=None) -> tuple:
    """``train_step`` over ``batches``: the (global) losses and each step's
    host time after a synchronize. From step ``timed_from`` on, the mesh's
    collectives are timed too (the device synchronised around each)."""
    from composer_tpu_torch.parallel import mesh as mesh_lib

    generator = trainer.make_dropout_generator()
    losses, seconds = [], []
    for index, (x, y) in enumerate(batches):
        if timed_from is not None and index == timed_from:
            mesh_lib.COLLECTIVE_TIME.update(timed=True, calls=0, seconds=0.0)
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = trainer.train_step(state, x, y, generator)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        losses.append(float(metrics["loss"]))
    mesh_lib.COLLECTIVE_TIME["timed"] = False
    return losses, seconds


def mesh_requests(config) -> list:
    prompt = encoded_prompt(config, max(MESH_SERVE_PLENS) + 3)
    return [prompt[index:index + length] for index, length in enumerate(MESH_SERVE_PLENS)]


def mesh_rank_main(rank: int, work: Path) -> int:
    """One of phase 13's two ranks (``--mesh-rank R DIR``), on ``cuda:0``
    beside the other; writes its results to ``DIR/rank<R>.pt``."""
    import datetime

    import torch.distributed as dist

    from composer_tpu_torch.data import WindowDataset
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.ops import launch_counts, reset_launch_counts
    from composer_tpu_torch.parallel import create_mesh, initialize_multihost
    from composer_tpu_torch.parallel import mesh as mesh_lib
    from composer_tpu_torch.serving import GenerationService
    from composer_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    initialize_multihost(f"file://{work}/store", 2, rank, backend="gloo",
                         timeout=datetime.timedelta(seconds=120))
    try:
        config = mesh_config()
        stream = np.load(work / "stream.npy")
        batches = list(WindowDataset(stream, TRAIN_BATCH, TRAIN_WINDOW, shuffle=False))
        tp, dp = create_mesh(1, 2, device=device), create_mesh(2, 1, device=device)
        out = {}

        # (a) tensor parallel: 3 float32 steps through Trainer.train, then 5 bf16.
        reset_launch_counts()
        trainer = Trainer(mesh_model(config, torch.float32), ModelType.TRANSFORMER, 1e-3,
                          mesh=tp, seed=0)
        state = trainer.init_state(TRAIN_BATCH, TRAIN_WINDOW)
        losses = []
        step = trainer.train_step

        def recorded(*args, **kwargs):
            metrics = step(*args, **kwargs)
            losses.append(float(metrics["loss"]))
            return metrics

        trainer.train_step = recorded
        torch.cuda.synchronize()
        start = time.perf_counter()
        state = trainer.train(WindowDataset(stream[:MESH_F32_STEPS * TRAIN_BATCH
                                                   * (TRAIN_WINDOW + 1)],
                                            TRAIN_BATCH, TRAIN_WINDOW, shuffle=False),
                              state, work / "tp", epochs=1, show_progress_bar=False)
        torch.cuda.synchronize()
        out["tp_f32_s"] = time.perf_counter() - start
        del trainer.train_step
        out["tp_f32_losses"] = losses
        out["tp_launches"] = flash_counts(("tf32x3", 16))
        out["tp_heads"] = trainer.model.blocks[0].attn.heads
        gathered = trainer.checkpoint_state(state)["params"]
        if rank == 0:
            torch.save({name: t.cpu() for name, t in gathered.items()}, work / "tp_gathered.pt")
        trainer = Trainer(mesh_model(config, torch.bfloat16), ModelType.TRANSFORMER, 1e-3,
                          mesh=tp, seed=0)
        state = trainer.init_state(TRAIN_BATCH, TRAIN_WINDOW)
        out["tp_bf16_losses"], out["tp_bf16_seconds"] = mesh_steps(
            trainer, state, batches[:MESH_BF16_STEPS], timed_from=1)
        out["tp_bf16_collective"] = dict(mesh_lib.COLLECTIVE_TIME)

        # (b) data parallel: 3 float32 steps at 4 rows a rank.
        trainer = Trainer(mesh_model(config, torch.float32), ModelType.TRANSFORMER, 1e-3,
                          mesh=dp, seed=0)
        state = trainer.init_state(TRAIN_BATCH, TRAIN_WINDOW)
        out["dp_f32_losses"], out["dp_f32_seconds"] = mesh_steps(
            trainer, state, batches[:MESH_F32_STEPS], timed_from=1)
        out["dp_f32_collective"] = dict(mesh_lib.COLLECTIVE_TIME)
        del trainer, state

        # (d) serving: GenerationService on the (1, 2) mesh, 4 greedy requests.
        model = mesh_model(config, torch.float32, stddev=0.2)
        model.reset_parameters(torch.Generator().manual_seed(1))
        service = GenerationService(model, ModelType.TRANSFORMER, None, 390, max_batch_size=4,
                                    max_wait_ms=2000.0, mesh=tp)
        if service.is_leader:
            responses = [None] * len(MESH_SERVE_PLENS)

            def ask(index, prompt):
                responses[index] = service.submit(prompt, length=MESH_SERVE_LENGTH,
                                                  temperature=0.0)

            threads = [threading.Thread(target=ask, args=(i, p))
                       for i, p in enumerate(mesh_requests(config))]
            start = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(MESH_JOIN_S)
            out["serve_s"] = time.perf_counter() - start
            service.close()
            out["responses"] = responses
            out["serve_batches"] = service.batch_sizes
        else:
            service.wait_closed(MESH_JOIN_S)
        out["launches"] = launch_counts()
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def mesh_path(device, card: str) -> dict:
    """Phase 13: the mesh on the one card. Two gloo ranks, each a process,
    both on ``cuda:0`` (NCCL puts no two ranks on one card; gloo's
    ``all_reduce`` and ``broadcast`` take CUDA tensors through the host),
    at the default model's full width (``mesh_config``) on 8 x 1024
    codec-encoded ids: (a) tensor parallel on (1, 2), 3 float32 steps (TF32
    off) through ``Trainer.train`` against one process's ``Trainer`` on the
    same weights and batches, each rank launching the flash pair 8 x 3 times
    at 8 heads, then 5 bf16 steps timed with the collectives' share; (b)
    data parallel on (2, 1), 3 float32 steps at 4 rows a rank against the
    same run; (c) (a)'s checkpoint restored in one process equals the
    gathered mesh parameters exactly; (d) ``GenerationService`` on (1, 2),
    4 greedy float32 requests, equal to one process's ``generate_ids(
    engine="xla")`` on the same batch. Returns each rank's launch counts."""
    from composer_tpu_torch.data import WindowDataset
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.serving import _pow2_ceil
    from composer_tpu_torch.train.generate import generate_ids
    from composer_tpu_torch.train.trainer import Trainer

    phase_start = time.perf_counter()
    config = mesh_config()
    events = MESH_BF16_STEPS * TRAIN_BATCH * (TRAIN_WINDOW + 1)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        stream = training_corpus(config, events)[:events]
        np.save(work / "stream.npy", stream)
        ranks = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
                                   str(rank), str(work)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for rank in range(2)]
        try:
            # One process, meanwhile: the same steps on the same batches.
            batches = list(WindowDataset(stream, TRAIN_BATCH, TRAIN_WINDOW, shuffle=False))
            reference = {}
            for name, dtype, steps in (("f32", torch.float32, MESH_F32_STEPS),
                                       ("bf16", torch.bfloat16, MESH_BF16_STEPS)):
                trainer = Trainer(mesh_model(config, dtype), ModelType.TRANSFORMER, 1e-3,
                                  seed=0, device=device)
                state = trainer.init_state(TRAIN_BATCH, TRAIN_WINDOW)
                reference[name] = mesh_steps(trainer, state, batches[:steps])
            del trainer, state
            logs = [rank.communicate(timeout=MESH_JOIN_S)[0] for rank in ranks]
        finally:
            for rank in ranks:
                if rank.poll() is None:
                    rank.kill()
                    rank.wait()
        for index, (rank, log) in enumerate(zip(ranks, logs)):
            if rank.returncode != 0:
                raise AssertionError(f"mesh rank {index} failed (exit code "
                                     f"{rank.returncode}):\n{log[-6000:]}")
        results = [torch.load(work / f"rank{index}.pt", weights_only=False) for index in range(2)]

        # (c) the checkpoint in one process against the gathered parameters.
        single = Trainer(mesh_model(config, torch.float32), ModelType.TRANSFORMER, 1e-3,
                         device=device).restore(work / "tp", TRAIN_BATCH, TRAIN_WINDOW)
        gathered = torch.load(work / "tp_gathered.pt", weights_only=True)
        restored = single.model.state_dict()
        exact = all(torch.equal(restored[name].cpu(), t) for name, t in gathered.items())
        exact &= set(gathered) == set(restored)
        del single

    # (d) one process on the batch the service ran: the prompts padded to
    # their power-of-two width, decoded to the length's power of two.
    model = mesh_model(config, torch.float32, stddev=0.2)
    model.reset_parameters(torch.Generator().manual_seed(1))
    model.to(device)
    prompts = mesh_requests(config)
    width = _pow2_ceil(max(MESH_SERVE_PLENS))
    padded = np.zeros((len(prompts), width), np.int32)
    for row, prompt in enumerate(prompts):
        padded[row, :len(prompt)] = prompt
    ids = generate_ids(model, ModelType.TRANSFORMER, None, padded,
                       length=_pow2_ceil(MESH_SERVE_LENGTH), temperature=0.0,
                       prompt_lengths=np.asarray(MESH_SERVE_PLENS, np.int32), engine="xla")
    want = [np.concatenate([p, ids[row, width:width + MESH_SERVE_LENGTH]])
            for row, p in enumerate(prompts)]
    leader = results[0]
    served_equal = all(np.array_equal(got, w) for got, w in zip(leader["responses"], want))
    del model

    f32_ref, f32_seconds = reference["f32"]
    bf16_ref, bf16_seconds = reference["bf16"]

    def rel(got, ref):
        return max(abs(a - b) / abs(b) for a, b in zip(got, ref))

    tp_f32, dp_f32 = rel(leader["tp_f32_losses"], f32_ref), rel(leader["dp_f32_losses"], f32_ref)
    tp_bf16 = rel(leader["tp_bf16_losses"], bf16_ref)
    bf16_step = float(np.mean(leader["tp_bf16_seconds"][1:]))
    bf16_share = leader["tp_bf16_collective"]["seconds"] / sum(leader["tp_bf16_seconds"][1:])
    dp_step = float(np.mean(leader["dp_f32_seconds"][1:]))
    dp_share = leader["dp_f32_collective"]["seconds"] / sum(leader["dp_f32_seconds"][1:])
    print(f"mesh (a) TP (1, 2) f32 losses {leader['tp_f32_losses']} against one process "
          f"{f32_ref}: worst {tp_f32:.2e} relative; flash launches a rank (fwd, bwd) "
          f"{[r['tp_launches'] for r in results]} at {leader['tp_heads']} heads; 3 steps "
          f"through Trainer.train {leader['tp_f32_s']:.2f} s", flush=True)
    print(f"mesh (a) TP (1, 2) bf16 losses {leader['tp_bf16_losses']} against one process "
          f"{bf16_ref}: worst {tp_bf16:.2e}; step {bf16_step * 1e3:.1f} ms (steps 2-"
          f"{MESH_BF16_STEPS}; one process {np.mean(bf16_seconds[1:]) * 1e3:.1f} ms), "
          f"collectives {leader['tp_bf16_collective']['calls']} calls, "
          f"{bf16_share * 100:.1f}% of the steps (two gloo ranks sharing one card, device "
          f"synchronised around each collective) [{card}]", flush=True)
    print(f"mesh (b) DP (2, 1) f32 losses {leader['dp_f32_losses']}: worst {dp_f32:.2e}; step "
          f"{dp_step * 1e3:.1f} ms (one process {np.mean(f32_seconds[1:]) * 1e3:.1f} ms), "
          f"collectives {dp_share * 100:.1f}% of the steps [{card}]", flush=True)
    print(f"mesh (c) checkpoint restored in one process equals the gathered parameters: "
          f"{exact}; (d) GenerationService on (1, 2): batches {leader['serve_batches']}, "
          f"4 greedy f32 responses equal to one process's generate_ids(engine='xla'): "
          f"{served_equal} in {leader['serve_s']:.2f} s", flush=True)
    elapsed = time.perf_counter() - phase_start
    print(f"phase 13 took {elapsed:.1f} s (host clock)", flush=True)
    expected = (MESH_F32_STEPS * 8,) * 2
    if any(r["tp_launches"] != expected for r in results) or leader["tp_heads"] != 8:
        raise AssertionError(f"mesh flash launches {[r['tp_launches'] for r in results]} at "
                             f"{leader['tp_heads']} heads, wanted {expected} at 8")
    if tp_f32 > MESH_F32_LOSS_RTOL or dp_f32 > MESH_F32_LOSS_RTOL:
        raise AssertionError(f"mesh f32 losses off by {tp_f32} (TP) and {dp_f32} (DP)")
    if tp_bf16 > MESH_BF16_LOSS_RTOL:
        raise AssertionError(f"mesh bf16 losses off by {tp_bf16}")
    if not exact:
        raise AssertionError("the mesh checkpoint does not restore to the gathered parameters")
    if leader["serve_batches"] != [len(MESH_SERVE_PLENS)] or not served_equal:
        raise AssertionError(f"mesh serving: batches {leader['serve_batches']}, equal "
                             f"{served_equal}")
    return {"launches": [r["launches"] for r in results], "seconds": elapsed}


# Phase 14: each bench row but the headline, cut for time where its default
# would take seconds, with the launch counts (``ops.launch_counts`` keys) of
# which at least one must rise (none for the rows that run no kernel).
BENCH_CASES = (
    ("speculative", lambda b: b.run_speculative_benchmark(length=256), ("spec", "single")),
    ("batched decode", lambda b: b.run_batched_decode_benchmark(batch_size=4, length=64,
                                                                repeats=1), ("batched",)),
    ("wide int8", lambda b: b.run_wide_int8_decode_benchmark(batch_size=2, length=64),
     ("wide",)),
    ("wide int8 K/V", lambda b: b.run_wide_int8_kv_decode_benchmark(batch_size=2, length=64),
     ("wide",)),
    ("Poisson, continuous", lambda b: b.run_poisson_serving_benchmark(requests=6, length=64),
     ("segment",)),
    ("Poisson, run-to-completion", lambda b: b.run_poisson_serving_benchmark(
        continuous=False, requests=6, length=64), ("batched", "single")),
    ("Poisson, embed 1024 continuous", lambda b: b.run_poisson_serving_benchmark(
        requests=4, length=64, slots=4, embed_dim=1024, mean_interarrival_ms=150.0,
        temperature=0.0), ("segment_wide",)),
    ("serving", lambda b: b.run_serving_benchmark(concurrency=4, length=256), ("batched",)),
    ("overload soak", lambda b: b.run_overload_soak_benchmark(duration_s=2.0, lengths=(64, 128)),
     ("segment",)),
    ("long prompt", lambda b: b.run_long_prompt_serving_benchmark(requests=2), ("segment",)),
    ("train, flash", lambda b: b.run_train_benchmark(batch_size=2, window_size=1024, steps=2,
                                                     use_pallas_attention=True),
     ("flash_fwd mma 16", "flash_bwd mma 16")),
    ("MusicRNN train", lambda b: b.run_rnn_train_benchmark(steps=2), ()),
    ("MusicRNN decode", lambda b: b.run_rnn_decode_benchmark(length=128, repeats=1), ()),
    ("preprocess", lambda b: b.run_preprocess_benchmark(num_files=4, num_workers=2,
                                                        scaling_workers=()), ()),
)


def bench_path(card: str, decode_ms: dict) -> dict:
    """Phase 14: the bench module and the CLI's ``benchmark`` on the card
    (see the module docstring). ``decode_ms`` holds phase 3's kernel times;
    returns the launches of the phase by ``ops.launch_counts`` key."""
    import io

    from composer_tpu_torch import bench, cli

    phase_start = time.perf_counter()
    reset_kernel_launch_counts()

    line = bench.headline()
    detail, batch1 = line["detail"], line["detail"]["batch1"]
    print(f"bench headline: {line['value']} events/s at 8 x 1014 (wall {detail['seconds']} s, "
          f"on device {detail['on_device_seconds']} s against phase 3's kernel "
          f"{decode_ms['batched'] / 1e3:.4f} s); batch1 {batch1} [{card}]", flush=True)
    if "error" in batch1:
        raise AssertionError(f"bench headline batch1: {batch1['error']}")
    if not detail["launches"].get("batched") or not batch1["launches"].get("single"):
        raise AssertionError(f"bench headline launches {detail['launches']} / "
                             f"{batch1['launches']}: decode_generate not taken at B=8 and B=1")
    for name, part in (("B=8", detail), ("B=1", batch1)):
        if part["on_device_seconds"] is None or part["seconds"] < part["on_device_seconds"]:
            raise AssertionError(f"bench headline {name}: wall {part['seconds']} s against "
                                 f"on-device {part['on_device_seconds']} s")
    if abs(detail["on_device_seconds"] * 1e3 - decode_ms["batched"]) > 0.1 * decode_ms["batched"]:
        raise AssertionError(f"bench headline on-device {detail['on_device_seconds']} s is not "
                             f"within 10% of phase 3's {decode_ms['batched']:.2f} ms")

    for name, run, kernels in BENCH_CASES:
        start = time.perf_counter()
        result = run(bench)
        if "error" in result or not {"metric", "value", "unit", "vs_baseline",
                                     "detail"} <= set(result):
            raise AssertionError(f"bench {name}: {result}")
        launches = result["detail"].get("launches", {})
        print(f"bench {name}: {result['metric']} {result['value']} {result['unit']}, "
              f"launches {launches}, {time.perf_counter() - start:.1f} s; "
              f"{json.dumps(result['detail'])[:600]}", flush=True)
        if kernels and not any(launches.get(key) for key in kernels):
            raise AssertionError(f"bench {name}: none of {kernels} launched ({launches})")
        if name == "overload soak" and result["detail"]["other_errors"]:
            raise AssertionError(f"bench {name}: {result['detail']['other_errors']} requests "
                                 "failed")

    # The CLI's command in process, its stdout captured.
    before = kernel_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.cli.main(["benchmark", "--length", "64", "--batch-size", "8"],
                            standalone_mode=False)
    lines = [text for text in out.getvalue().splitlines() if text.startswith("{")]
    result = json.loads(lines[-1]) if len(lines) == 1 else {}
    after = kernel_launch_counts()
    print(f"bench CLI benchmark --length 64 --batch-size 8: exit {code}, {lines}", flush=True)
    if code not in (None, 0) or not {"metric", "value", "unit", "vs_baseline",
                                     "detail"} <= set(result) or \
            after["batched"] <= before["batched"]:
        raise AssertionError(f"bench CLI: exit {code}, output {out.getvalue()[-2000:]}")

    launches = kernel_launch_counts()
    print(f"phase 14 launches {({k: v for k, v in launches.items() if v})}; took "
          f"{time.perf_counter() - phase_start:.1f} s (host clock)", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-rank"] and len(sys.argv) == 4:
        return mesh_rank_main(int(sys.argv[2]), Path(sys.argv[3]))
    from concurrent.futures import ThreadPoolExecutor

    from composer_tpu_torch.config import get_default
    from composer_tpu_torch.native import loader as native_loader
    from composer_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if sys.argv[1:] == ["--flash-planted-faults"]:
        return flash_planted_faults(device, card)
    parent = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        parent = ThreadPoolExecutor(1).submit(parent_libraries, sys.argv[2])
    elif sys.argv[1:]:
        print(__doc__, file=sys.stderr)
        return 2
    start = time.perf_counter()
    libraries = ("decode_generate", "flash_attention", "spec_decode", "decode_segment",
                 "decode_wide", "decode_wide_segment")
    native_build = ThreadPoolExecutor(1).submit(
        lambda: (native_loader.build(), time.perf_counter() - start)[1])
    _build.build_all(libraries)
    print(f"native codec build (g++, {native_loader.library_path().name}): "
          f"{native_build.result():.1f} s after the start, beside nvcc", flush=True)
    for name in libraries:
        _build.load_library(name)
        print(_build.BUILD_INFO[name]["log"].strip(), flush=True)
    each = ", ".join(f"{name} {_build.BUILD_INFO[name]['seconds']:.1f} s" for name in libraries)
    print(f"kernel build: {time.perf_counter() - start:.1f} s ({each})", flush=True)

    def phase_done(name: str) -> None:
        print(f"{name} done at {time.perf_counter() - start:.1f} s (host clock)", flush=True)

    errors = kernel_vs_plain(device)
    phase_done("phase 2")
    path = main_path(device, card)
    times = timings(device, path["engine"], path["prompt"], card)
    phase_done("phases 2-3")
    flash_check = flash_vs_plain(device)
    phase_done("phase 4")
    training = train_path(device, card, path["prompt"])
    phase_done("phase 5")
    flagship_training = flagship_train_path(device, card)
    phase_done("phase 5b")
    wide_training = embed2048_train_path(device, card, get_default())
    wide_2048_error = wide_2048_vs_plain(device)
    phase_done("phase 5c")
    parent = parent.result() if parent is not None else None
    width_training = width_train_path(device, card, get_default(),
                                      parent and parent["flash_attention"])
    width_step_ms = width_training.pop("step_ms")
    phase_done("phase 5d")
    from composer_tpu_torch.ops import flash_attention as fa

    flash_times = {variant: flash_timings(
        device, card, fa.DTYPES[variant[0]], shape, plain_repeats=1 if shape[2] > 1024 else 3,
        parent=parent["flash_attention"] if parent and variant[0] == "tf32x3" else None)
                   for variant, shape in FLASH_TIMED.items()}
    phase_done("flash timings")
    if parent and "flash_attention" not in parent["unchanged"]:
        for depth in (64, 128):
            for case, case_times in flash_times[("tf32x3", depth)].items():
                for direction in ("fwd", "bwd"):
                    if not case_times[direction] < min(case_times[f"parent_{direction}"]):
                        raise AssertionError(f"flash f32 D={depth} (rel, dropout) {case} "
                                             f"{direction}: not faster than the parent's kernel")
    spec_error = spec_vs_plain(device)
    phase_done("phase 6a")
    spec_vs_sequential(device)
    phase_done("phase 6a'")
    spec = spec_path(device, card, training["restored"], parent)
    phase_done("phase 6")
    segment_error = segment_vs_plain(device)
    phase_done("phase 7a")
    segment = segment_timings(device, card)
    phase_done("phase 7b")
    serve = serve_path(device, card)
    phase_done("phase 7")
    flagship = build_flagship(device)
    wide_error = wide_vs_plain(device, flagship)
    phase_done("phase 8a")
    wide_path = flagship_path(device, card, flagship, get_default())
    phase_done("phase 8b")
    wide = wide_timings(device, card, flagship, wide_path, times["batched"][0], parent)
    phase_done("phase 8")
    wide_segment_error = wide_segment_vs_plain(device, flagship)
    phase_done("phase 9a")
    wide_segment = wide_segment_timings(device, card, flagship, parent)
    phase_done("phase 9b")
    wide_serve = wide_serve_path(device, card, flagship, wide_segment["first_ms"])
    phase_done("phase 9")
    http = http_path(device, card, flagship, wide_path["fused_packed"])
    phase_done("phase 10")
    cli = cli_path(device, card)
    phase_done("phases 6-11")
    rnn_path(device, card, get_default())
    phase_done("phase 12")
    mesh = mesh_path(device, card)
    phase_done("phase 13")
    bench_launches = bench_path(card, {"batched": times["batched"][0]})
    phase_done("phase 14")

    source = "composer_tpu_torch/csrc/decode_generate.cu"
    num_steps = PROMPT_EVENTS + GENERATE_EVENTS - 1
    kernels = []
    for form, batch, replaces in (("batched", 8, "composer_tpu/ops/decode_kernel_batched.py:100"),
                                  ("single", 1, "composer_tpu/ops/decode_kernel.py:203")):
        ms, by = decode_bound(path["engine"], batch, num_steps)
        kernels.append({
            "name": f"decode_generate ({'B>1' if batch > 1 else 'B=1'})", "route": "cuda",
            "source": source, "replaces": replaces, "launches": path["launches"][form],
            "max_abs_err": errors[form], "ms": times[form][0], "plain_ms": times[form][1],
            "bound_ms": ms, "bound_by": by, "library_ms": None,
            "cluster": path["clusters"][form], "http_launches": http[form],
            "cli_launches": cli[form]})
    flash_launches = {("mma", 16): training["launches"][("mma", 16)],
                      ("mma", 64): flagship_training["launches"],
                      ("mma", 128): wide_training["launches"],
                      ("tf32x3", 16): training["launches"][("tf32x3", 16)], **width_training}
    # One entry a direction for each (dtype, head_dim) built: max_abs_err is
    # absolute, beside its tensor's scale (err_scale) and, for bf16, the
    # largest row error of the row's norm (row_rel_err); times at
    # FLASH_TIMED's shape, bias off, dropout 0.
    for variant in fa.VARIANTS:
        dtype = str(fa.DTYPES[variant[0]])[6:]
        source = "flash_attention_mma.cuh" if variant[0] == "mma" else "flash_attention_tf32.cuh"
        times = flash_times[variant][(False, 0.0)]
        for index, (direction, replaces) in enumerate((
                ("fwd", "composer_tpu/ops/pallas_attention.py:235"),
                ("bwd", "composer_tpu/ops/pallas_attention.py:294"))):
            check = flash_check[variant][direction]
            kernels.append({
                "name": f"flash_attention_{direction}", "route": "cuda",
                "variant": variant[0], "dtype": dtype, "head_dim": variant[1],
                "shape": list(FLASH_TIMED[variant]),
                "source": f"composer_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": flash_launches[variant][index],
                "max_abs_err": check["max_abs_err"], "err_scale": check["scale"],
                "row_rel_err": check.get("row_rel_err"), "ms": times[direction],
                "plain_ms": times[f"plain_{direction}"], "bound_ms": times[f"bound_{direction}"],
                "bound_by": times[f"bound_by_{direction}"],
                "library_ms": times[f"sdpa_{direction}"], "library": times["sdpa_backend"],
                "parent_ms": times.get(f"parent_{direction}"),
                "train_step_ms": width_step_ms.get(variant), "cluster": None,
                "http_launches": http[f"flash_{direction} {variant[0]} {variant[1]}"],
                "cli_launches": cli[f"flash_{direction} {variant[0]} {variant[1]}"]})
    kernels.append({
        "name": "spec_decode (B=1)", "route": "cuda",
        "source": "composer_tpu_torch/csrc/spec_decode.cu",
        "replaces": "composer_tpu/ops/decode_kernel_spec.py:120", "launches": spec["launches"],
        "max_abs_err": spec_error, "ms": spec["ms"], "plain_ms": spec["plain_ms"],
        "bound_ms": spec["bound_ms"], "bound_by": spec["bound_by"], "library_ms": None,
        "cluster": spec["cluster"], "parent_ms": spec["parent_ms"],
        "http_launches": http["spec"], "cli_launches": cli["spec"]})
    kernels.append({
        "name": "decode_segment", "route": "cuda",
        "source": "composer_tpu_torch/csrc/decode_segment.cu",
        "replaces": "composer_tpu/ops/decode_kernel_segmented.py:62",
        "launches": serve["launches"], "max_abs_err": segment_error, "ms": segment["ms"],
        "plain_ms": segment["plain_ms"], "bound_ms": segment["bound_ms"],
        "bound_by": segment["bound_by"], "library_ms": None, "cluster": segment["cluster"],
        "http_launches": http["segment"], "cli_launches": cli["segment"]})
    wide_bound_ms, wide_bound_by = wide[8]["bound bf16"]
    kernels.append({
        "name": "decode_wide", "route": "cuda", "source": "composer_tpu_torch/csrc/decode_wide.cu",
        "replaces": "composer_tpu/ops/decode_kernel_wide.py:153", "launches": wide_path["launches"],
        "max_abs_err": wide_error, "ms": wide[8]["bf16"], "plain_ms": wide[8]["plain_ms"],
        "bound_ms": wide_bound_ms, "bound_by": wide_bound_by, "library_ms": None,
        "cluster": None, "parent_ms": wide[8]["parent_ms"], "http_launches": http["wide"],
        "cli_launches": cli["wide"], "embed2048_max_abs_err": wide_2048_error,
        "embed2048_sub_batch": wide_training["sub_batch"]})
    kernels.append({
        "name": "decode_segment_wide", "route": "cuda",
        "source": "composer_tpu_torch/csrc/decode_wide_segment.cu",
        "replaces": "composer_tpu/ops/decode_kernel_wide_segmented.py:151",
        "launches": wide_serve["launches"], "max_abs_err": wide_segment_error,
        "ms": wide_segment["ms"], "plain_ms": wide_segment["plain_ms"],
        "bound_ms": wide_segment["bound_ms"], "bound_by": wide_segment["bound_by"],
        "library_ms": None, "cluster": None, "parent_ms": wide_segment["parent_ms"],
        "http_launches": http["segment_wide"], "cli_launches": cli["segment_wide"]})
    # Each kernel's launches on each of phase 13's two ranks.
    counter = {"decode_generate (B>1)": "batched", "decode_generate (B=1)": "single",
               "spec_decode (B=1)": "spec", "decode_segment": "segment",
               "decode_wide": "wide", "decode_segment_wide": "segment_wide"}
    for entry in kernels:
        key = counter.get(entry["name"])
        if key is None:
            name = entry["name"].replace("_attention", "")
            key = f"{name} {entry['variant']} {entry['head_dim']}"
        entry["mesh_launches"] = [launches[key] for launches in mesh["launches"]]
        entry["bench_launches"] = bench_launches[key]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
