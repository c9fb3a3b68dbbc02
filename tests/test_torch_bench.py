"""The port's bench (``composer_tpu_torch/bench.py``) on the CPU: every
``run_*`` at the tiny shapes of ``tests/test_bench_smoke.py`` returns the
schema with the JAX function's metric and unit, the FLOP counts equal the
JAX package's, the preprocess row produces the JAX row's files, the Poisson
traffic is drawn in the JAX package's order, ``run_all`` keeps the JAX
table's rows and writes its markdown only where it is told, and the CLI's
``benchmark`` command and ``python -m composer_tpu_torch.bench`` behave as
documented without a card. The continuous-serving rows run at embed 128
(head_dim 8, the least the segment kernel's fit check admits) where the JAX
smoke tests use 32."""

from __future__ import annotations

import inspect
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from composer_tpu import bench as jax_bench
from composer_tpu_torch import bench
from composer_tpu_torch import cli as port_cli

REPO = Path(__file__).resolve().parent.parent
SERVING_TINY = dict(slots=2, seg_steps=4, embed_dim=128, num_layers=1, cache_len=128,
                    temperature=0.0, device="cpu")

# A 2-layer transformer of embed 16 (head_dim 8) over the default vocabulary
# of 390 events.
TINY_CONFIG = """
dataset:
    time_step_increment: 10
    max_time_steps: 100
    velocity_bins: 32
    time_stretch_range: {start: 0.90, stop: 1.10}
    pitch_shift_range: {start: -4, stop: 4}
    trim_start: true
transformer:
    model:
        window_size: 16
        embedding_size: 16
        decoder_layers_count: 2
        attention_head_count: 2
        use_relative_attention: false
        attention_dropout_rate: 0.0
        residual_dropout_rate: 0.0
        layer_normalization_epsilon: 0.00001
        scale_attention: true
        initializer_mean: 0
        initializer_stddev: 0.02
        use_layer_normalization: true
    train: {batch_size: 2, learning_rate: 0.01}
"""

# name -> (the port's call at a tiny shape, the JAX function whose body
# states the metric and unit)
RUNS = {
    "decode": (lambda: bench.run_decode_benchmark(length=12, prompt_length=4, repeats=1,
                                                  device="cpu"),
               jax_bench.run_decode_benchmark),
    "batched_decode": (lambda: bench.run_batched_decode_benchmark(
        batch_size=2, length=12, prompt_length=4, repeats=1, device="cpu"),
        jax_bench.run_batched_decode_benchmark),
    "wide_int8": (lambda: bench.run_wide_int8_decode_benchmark(
        batch_size=2, length=4, embed_dim=256, device="cpu"), jax_bench.run_decode_benchmark),
    "wide_int8_kv": (lambda: bench.run_wide_int8_kv_decode_benchmark(
        batch_size=2, length=4, embed_dim=256, device="cpu"), jax_bench.run_decode_benchmark),
    "rnn_decode": (lambda: bench.run_rnn_decode_benchmark(length=12, batch_size=2, repeats=1,
                                                          device="cpu"),
                   jax_bench.run_rnn_decode_benchmark),
    "speculative": (lambda: bench.run_speculative_benchmark(length=8, prompt_length=4,
                                                            device="cpu"),
                    jax_bench.run_speculative_benchmark),
    "serving": (lambda: bench.run_serving_benchmark(
        concurrency=3, length=8, prompt_length=4, max_batch_size=2, device="cpu"),
        jax_bench.run_serving_benchmark),
    "poisson": (lambda: bench.run_poisson_serving_benchmark(
        continuous=True, requests=4, mean_interarrival_ms=5.0, lengths=(4, 6),
        **SERVING_TINY), jax_bench.run_poisson_serving_benchmark),
    "poisson_run_to_completion": (lambda: bench.run_poisson_serving_benchmark(
        continuous=False, requests=4, mean_interarrival_ms=5.0, lengths=(4, 6),
        **SERVING_TINY), jax_bench.run_poisson_serving_benchmark),
    "overload_soak": (lambda: bench.run_overload_soak_benchmark(
        duration_s=2.0, mean_interarrival_ms=50.0, lengths=(4, 6), max_queue_depth=2,
        deadline_ms=60_000.0, **SERVING_TINY), jax_bench.run_overload_soak_benchmark),
    "long_prompt": (lambda: bench.run_long_prompt_serving_benchmark(
        prompt_len=12, length=4, requests=2, prefill=True, prefill_min=4, **SERVING_TINY),
        jax_bench.run_long_prompt_serving_benchmark),
    "preprocess": (lambda: bench.run_preprocess_benchmark(num_files=2),
                   jax_bench.run_preprocess_benchmark),
    "train": (lambda: bench.run_train_benchmark(batch_size=2, window_size=64, steps=1,
                                                device="cpu"),
              jax_bench.run_train_benchmark),
    "train_flash": (lambda: bench.run_train_benchmark(
        batch_size=2, window_size=64, steps=1, use_pallas_attention=True, device="cpu"),
        jax_bench.run_train_benchmark),
    "rnn_train": (lambda: bench.run_rnn_train_benchmark(batch_size=2, window_size=16,
                                                        steps=1, device="cpu"),
                  jax_bench.run_rnn_train_benchmark),
}
# Rows whose value is an on-device rate: None off the card.
DEVICE_VALUED = {"speculative"}
# Rows that name the kernels they ran (none launch on the CPU).
WITH_LAUNCHES = {"decode", "batched_decode", "wide_int8", "wide_int8_kv", "speculative",
                 "serving", "poisson", "poisson_run_to_completion", "overload_soak",
                 "long_prompt", "train", "train_flash"}
# Rows that keep the JAX package's vs_baseline (tokens/s, files/s).
WITH_BASELINE = {"preprocess", "train", "train_flash", "rnn_train"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the suite's workers, more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def soak_counts(detail):
    assert detail["completed"] >= 1 and detail["final_queue_depth"] == 0
    assert detail["other_errors"] == 0
    assert (detail["completed"] + detail["rejected"] + detail["expired"]
            + detail["other_errors"]) == detail["requests"]


# What each row's detail must hold on the CPU, as the JAX smoke tests read it.
DETAIL_CHECKS = {
    "serving": lambda d: sum(d["coalesced_batches"]) == 3,
    "poisson": lambda d: d["occupancy_mean"] > 0 and d["offered_events_per_sec"] > 0,
    "overload_soak": lambda d: soak_counts(d) is None,
    "long_prompt": lambda d: d["total_p95_s"] >= d["ttft_p95_s"] > 0,
    "speculative": lambda d: (d["floor"]["tokens_per_block"] >= 1
                              and d["cycle"]["tokens_per_block"] >= 1
                              and d["sequential_on_device_marginal"] is None),
    "preprocess": lambda d: d["export_files_per_sec"] > 0,
    "decode": lambda d: d["on_device_seconds"] is None,
    "train": lambda d: d["attention"] == "plain" and np.isfinite(d["loss"]),
    "train_flash": lambda d: d["attention"] == "flash" and np.isfinite(d["loss"]),
    "wide_int8": lambda d: d["int8"] and d["engine"] == "wide",
    "wide_int8_kv": lambda d: d["int8_kv"] and d["engine"] == "wide",
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_returns_the_schema_with_the_jax_metric(name):
    run, jax_fn = RUNS[name]
    result = run()
    assert set(result) >= {"metric", "value", "unit", "vs_baseline", "detail"}, result
    assert "error" not in result
    if name in DEVICE_VALUED:
        assert result["value"] is None  # no device time on the CPU
    else:
        assert result["value"] > 0
    if name in WITH_BASELINE:
        assert result["vs_baseline"] > 0
    else:
        assert result["vs_baseline"] is None
    detail = result["detail"]
    if name != "preprocess":  # the host-only row names no device, as JAX's
        assert detail["backend"] == "cpu"
    if name in WITH_LAUNCHES:
        assert detail["launches"] == {}  # the plain versions count no launch
    assert DETAIL_CHECKS.get(name, lambda d: True)(detail), detail
    json.dumps(result)
    source = inspect.getsource(jax_fn)
    assert f'"metric": "{result["metric"]}"' in source
    assert f'"unit": "{result["unit"]}"' in source


GRID = list(itertools.product((1, 8, 32), (64, 2048), (256, 1024), (8, 16), (False, True)))


@pytest.mark.parametrize("batch, window, embed, heads, relative", GRID[::3])
def test_train_flops_equal_the_jax_counts(batch, window, embed, heads, relative):
    for layers in (1, 8):
        assert bench._transformer_train_tflops(batch, window, embed, heads, layers,
                                               relative=relative) == \
            jax_bench._transformer_train_tflops(batch, window, embed, heads, layers,
                                                relative=relative)
    assert bench._rnn_train_tflops(batch, window) == jax_bench._rnn_train_tflops(batch, window)
    assert bench._rnn_train_tflops(batch, window, embed, (embed, 2 * embed)) == \
        jax_bench._rnn_train_tflops(batch, window, embed, (embed, 2 * embed))


def test_preprocess_produces_the_jax_rows_files():
    port = bench.run_preprocess_benchmark(num_files=2, scaling_workers=())["detail"]
    jax = jax_bench.run_preprocess_benchmark(num_files=2, scaling_workers=())["detail"]
    assert (port["input_files"], port["output_files"]) == (jax["input_files"],
                                                           jax["output_files"])


def test_poisson_traffic_is_drawn_in_the_jax_order():
    """``_poisson_schedule`` against the draws of
    ``composer_tpu/bench.py:765-771``, replayed here, and the detail's
    request count and offered load against the JAX row's formula."""
    seed, requests, gap_ms, lengths = 3, 7, 40.0, (128, 256, 384)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(gap_ms / 1000.0, requests)
    plens = rng.integers(8, 65, requests)
    prompts = [rng.integers(0, 390, p).astype(np.int32) for p in plens]
    req_lengths = [int(lengths[i % len(lengths)]) for i in range(requests)]

    got_gaps, got_prompts, got_lengths = bench._poisson_schedule(seed, requests, gap_ms,
                                                                 lengths)
    np.testing.assert_array_equal(got_gaps, gaps)
    assert len(got_prompts) == requests
    for got, want in zip(got_prompts, prompts):
        np.testing.assert_array_equal(got, want)
    assert got_lengths == req_lengths

    detail = RUNS["poisson_run_to_completion"][0]()["detail"]
    assert detail["requests"] == 4 and detail["lengths"] == [4, 6]
    assert detail["offered_events_per_sec"] == round(float(np.mean([4, 6, 4, 6])) / 0.005, 1)


def test_speculative_row_reads_a_port_checkpoint(tmp_path, monkeypatch):
    """``restoredir``: the trained-model regimes, through the CLI's
    ``_make_trainer`` and ``get_config_from_restoredir``."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.train.checkpoint import CheckpointManager

    monkeypatch.setattr(port_cli, "_DEVICE", "cpu")
    (tmp_path / "config.yml").write_text(TINY_CONFIG)
    config = port_cli.get_config_from_restoredir(tmp_path)
    trainer = port_cli._make_trainer(ModelType.TRANSFORMER, config)
    state = trainer.init_state(2, 16)
    CheckpointManager(tmp_path).save(1, trainer.checkpoint_state(state))

    result = bench.run_speculative_benchmark(length=8, prompt_length=4, restoredir=str(tmp_path),
                                             device="cpu")
    detail = result["detail"]
    assert detail["trained_greedy"]["restoredir"] == str(tmp_path)
    assert detail["trained_greedy"]["tokens_per_block"] >= 1
    assert detail["trained_sampled"]["temperature"] == 0.9
    assert result["value"] is None  # the trained greedy marginal: no device time here


def stub(metric):
    def run(*args, **kwargs):
        return {"metric": metric, "value": 1.0, "unit": "u", "vs_baseline": None,
                "detail": {"kwargs": sorted(kwargs)}}
    return run


def test_run_all_keeps_the_jax_rows_and_writes_only_where_told(tmp_path, monkeypatch):
    for module in (bench, jax_bench):
        for name, fn in list(vars(module).items()):
            if name.startswith("run_") and name != "run_all" and callable(fn):
                monkeypatch.setattr(module, name, stub(name))
    root_markdown = REPO / "BENCHMARKS.md"
    before = root_markdown.read_bytes()
    default_before = (bench.DEFAULT_MARKDOWN.stat().st_mtime_ns
                      if bench.DEFAULT_MARKDOWN.exists() else None)

    jax_rows = jax_bench.run_all(write_markdown=False)
    rows = bench.run_all(markdown_path=None, device="cpu")
    target = tmp_path / "out" / "table.md"
    bench.run_all(markdown_path=target, device="cpu")

    assert [r["workload"] for r in rows] == [r["workload"] for r in jax_rows]
    # Off the card the port skips exactly the rows JAX skips off the TPU,
    # and runs the others with their JAX function and arguments.
    for port_row, jax_row in zip(rows, jax_rows):
        assert ("error" in port_row) == ("error" in jax_row), port_row["workload"]
        if "error" not in jax_row:
            assert port_row["metric"] == jax_row["metric"]
            assert set(port_row["detail"]["kwargs"]) - {"device"} == \
                set(jax_row["detail"]["kwargs"])
    assert root_markdown.read_bytes() == before
    assert (bench.DEFAULT_MARKDOWN.stat().st_mtime_ns
            if bench.DEFAULT_MARKDOWN.exists() else None) == default_before
    table = target.read_text()
    assert all(row["workload"] in table for row in rows)
    assert table.count("\n| ") == len(rows) + 1  # the header row and one a workload


def test_headline_is_the_root_bench_line(monkeypatch):
    calls = []

    def fake(**kwargs):
        calls.append(kwargs)
        batch = kwargs["batch_size"]
        return {"metric": "decode_events_per_sec", "value": float(batch), "unit": "u",
                "vs_baseline": None,
                "detail": {"seconds": 1.0, "on_device_seconds": None,
                           "on_device_events_per_sec_marginal": None, "launches": {}}}

    monkeypatch.setattr(bench, "run_decode_benchmark", fake)
    line = bench.headline(device="cpu")
    assert calls == [dict(length=1014, batch_size=8, device="cpu"),
                     dict(length=1024, batch_size=1, device="cpu")]
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["value"] == 8.0 and line["detail"]["batch1"]["events_per_sec_wall"] == 1.0


def test_cli_benchmark_prints_one_json_line():
    result = CliRunner().invoke(port_cli.cli, ["--device", "cpu", "benchmark", "--length", "8"])
    assert result.exit_code == 0, result.output
    lines = [line for line in result.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) >= {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["metric"] == "decode_events_per_sec" and line["value"] > 0
    assert line["detail"]["length"] == 8 and line["detail"]["backend"] == "cpu"


def test_without_a_card_the_bench_stops():
    """``--device cuda benchmark`` is a usage error (exit 2) and
    ``python -m composer_tpu_torch.bench`` exits non-zero with no result,
    where torch sees no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    result = CliRunner().invoke(port_cli.cli, ["--device", "cuda", "benchmark", "--length", "8"])
    assert result.exit_code == 2
    process = subprocess.run([sys.executable, "-m", "composer_tpu_torch.bench"],
                             cwd=REPO, capture_output=True, text=True, timeout=120)
    assert process.returncode != 0 and process.stdout == ""
    assert "CUDA" in process.stderr
    assert bench.main(["headline"]) == 1
    assert bench.main(["all"]) == 2  # a usage error, before any device question
