"""The port's mesh (``composer_tpu_torch/parallel``) against the JAX
package's, f32, on the CPU.

One spawn for the module: four gloo ranks, each a process of its own
(this file run as a script, one torch thread each), run every scenario in
turn on ``(data, model)`` meshes over them, while this process computes the
JAX package's runs on its 8-device virtual CPU mesh. Weights go from the
JAX init to the port through ``models/convert.py``; the ranks start from a
single-device checkpoint, which ``Trainer.restore`` slices on each rank.

Scenarios (``_rank_main``): the sharded flash plain version on (2, 2)
forward and backward; ``Trainer.train`` on (2, 2), then (1, 2) and (2, 1) on
two ranks each at once, 3
steps with relative attention, flash and clipping on, its checkpoint
gathered and written by the leader, then restored on the mesh; MusicRNN
with BatchNorm on (2, 1); greedy ``generate_ids``, ``GenerationService``
and sampled ``generate_ids`` on (2, 2). Every wait is bounded and the ranks
are killed when one fails.
"""

import datetime
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
RANK_TIMEOUT_S = 150  # the bound on the ranks' whole run
MESHES = ((1, 2), (2, 1), (2, 2))

# The Transformer trained on each mesh, and its batches.
TF = dict(vocab_size=64, embed_dim=32, window_size=128, num_layers=1, num_heads=2,
          use_relative_attention=True, use_pallas_attention=True,
          attention_dropout_rate=0.0, residual_dropout_rate=0.0)
# Adam's first updates are lr * g / (|g| + 1e-7): where |g| is near 1e-7,
# a difference in g's last f32 bits between the two frameworks moves the
# update by lr * dg / 1e-7. At lr 1e-2 and 1e-3 single weights of wte and
# wpe came out up to 2e-5 of their scale apart on these batches; at lr 1e-4
# that bound is 20x inside 1e-5 of scale, while a wrong gradient still
# moves weights by about lr (2e-3 of their scale).
BATCH, STEPS, LR, CLIP = 4, 3, 1e-4, 0.05
# MusicRNN with BatchNorm, data parallel.
RNN = dict(vocab_size=30, embed_dim=16, layer_sizes=(24,), dropout_rates=(0.0,),
           use_batch_normalization=True)
RNN_WINDOW = 16
# Generation (tests/test_mesh_generate.py's model, relative attention on).
GEN = dict(vocab_size=120, embed_dim=32, window_size=64, num_layers=2, num_heads=4,
           use_relative_attention=True, attention_dropout_rate=0.0,
           residual_dropout_rate=0.0, initializer_stddev=0.2)
SERVICE_PROMPTS = [[5, 8, 11], [100, 3], [7, 7, 7, 7], [42]]
# Flash: (batch, heads, seq, depth), relative window.
FLASH_SHAPE, FLASH_WINDOW = (4, 4, 128, 16), 256

# f32 in other summation orders: losses agreed to about 2e-7 relative and
# weights to about 2e-6 of their scale when this test was written.
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
FLASH_OUT_TOL, FLASH_GRAD_TOL = 2e-5, 5e-5


def _stream(seed, steps, batch, window, vocab):
    return np.random.default_rng(seed).integers(0, vocab, steps * batch * (window + 1))


def _flash_inputs():
    rng = np.random.default_rng(0)
    b, h, s, d = FLASH_SHAPE
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    e = (rng.standard_normal((h, FLASH_WINDOW, d)) * 0.02).astype(np.float32)
    return q, k, v, e


# ------------------------------------------------------------------ ranks
def _block(array, mesh):
    """This rank's (batch, heads) block of a [B, H, ...] array."""
    b, h = array.shape[0] // mesh.data, array.shape[1] // mesh.model
    return array[mesh.data_index * b:(mesh.data_index + 1) * b,
                 mesh.model_index * h:(mesh.model_index + 1) * h]


def _flash_scenario(mesh):
    from composer_tpu_torch.ops.flash_attention import sharded_relative_flash_attention

    q, k, v, e = _flash_inputs()
    heads = e.shape[0] // mesh.model
    blocks = [_block(a, mesh) for a in (q, k, v)]
    blocks.append(e[mesh.model_index * heads:(mesh.model_index + 1) * heads])
    q, k, v, e = (torch.from_numpy(np.ascontiguousarray(t)).requires_grad_() for t in blocks)
    out = sharded_relative_flash_attention(q, k, v, e, mesh=mesh)
    (out * out).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad, "de": e.grad}


def _train_scenario(mesh, model_type, model, init_dir, logdir, dataset):
    from composer_tpu_torch import ModelSaveFrequencyMode
    from composer_tpu_torch.train.trainer import Trainer

    trainer = Trainer(model, model_type, LR, mesh=mesh, gradient_clip_norm=CLIP,
                      device="cpu")
    state = trainer.restore(init_dir, dataset.batch_size, dataset.window_size)
    state = trainer.train(dataset, state, logdir, epochs=1,
                          save_frequency_mode=ModelSaveFrequencyMode.EPOCH,
                          show_progress_bar=False)
    gathered = trainer.checkpoint_state(state)
    again = Trainer(model, model_type, LR, mesh=mesh, gradient_clip_norm=CLIP, device="cpu")
    restored = again.restore(logdir, dataset.batch_size, dataset.window_size)
    live, back = state.state_dict(), restored.state_dict()
    same = all(torch.equal(live["params"][n], back["params"][n]) for n in live["params"])
    for moment in ("mu", "nu"):
        same &= all(torch.equal(a, b) for a, b in zip(live["opt_state"][moment],
                                                      back["opt_state"][moment]))
    return {"gathered": gathered["params"], "restored_equal": bool(same),
            "step": restored.step, "leader": trainer.is_leader}


def _rank_main(rank: int, work: Path) -> None:
    torch.set_num_threads(1)
    from composer_tpu_torch.data import WindowDataset
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models.music_rnn import MusicRNN, MusicRNNConfig
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.parallel import create_mesh, initialize_multihost, shard_params
    from composer_tpu_torch.serving import GenerationService
    from composer_tpu_torch.train.generate import generate_ids

    initialize_multihost(f"file://{work}/store", WORLD, rank, backend="gloo",
                         timeout=datetime.timedelta(seconds=60))
    results = {}
    mesh = create_mesh(2, 2, device="cpu")
    results["flash"] = _flash_scenario(mesh)

    # (2, 2) on every rank; then (1, 2) on ranks 0-1 beside (2, 1) on ranks
    # 2-3, and MusicRNN's (2, 1) on ranks 0-1 (no rank waits out a run).
    stream = _stream(1, STEPS, BATCH, TF["window_size"], TF["vocab_size"])
    meshes = [create_mesh(2, 2, device="cpu")]
    meshes += [create_mesh(1, 2, ranks=(0, 1), device="cpu"),
               create_mesh(2, 1, ranks=(2, 3), device="cpu")]
    for mesh in meshes:
        if mesh is None:
            continue
        shape = (mesh.data, mesh.model)
        dataset = WindowDataset(stream, BATCH, TF["window_size"], shuffle=False)
        results[shape] = _train_scenario(
            mesh, ModelType.TRANSFORMER, Transformer(TransformerConfig(**TF)),
            work / "tf_init", work / f"tf_{shape[0]}x{shape[1]}", dataset)

    mesh = create_mesh(2, 1, ranks=(0, 1), device="cpu")
    if mesh is not None:
        dataset = WindowDataset(_stream(2, STEPS, BATCH, RNN_WINDOW, RNN["vocab_size"]), BATCH,
                                RNN_WINDOW, shuffle=False)
        results["rnn"] = _train_scenario(mesh, ModelType.MUSIC_RNN,
                                         MusicRNN(MusicRNNConfig(**RNN)), work / "rnn_init",
                                         work / "rnn_2x1", dataset)

    mesh = create_mesh(2, 2, device="cpu")
    model = Transformer(TransformerConfig(**GEN))
    weights = torch.load(work / "gen.pt", weights_only=True)
    tp = Transformer(TransformerConfig(**GEN, flash_mesh=mesh))
    tp.load_state_dict(shard_params(weights, mesh))
    prompts = np.random.default_rng(3).integers(0, GEN["vocab_size"], (8, 4))
    results["greedy"] = generate_ids(tp, ModelType.TRANSFORMER, None, prompts, length=16,
                                     temperature=0.0, engine="xla")
    results["sampled"] = generate_ids(tp, ModelType.TRANSFORMER, None, prompts[:4],
                                      length=16, temperature=1.0, seed=5)
    model.load_state_dict(weights)
    service = GenerationService(model, ModelType.TRANSFORMER, None, GEN["vocab_size"],
                                max_batch_size=4, max_wait_ms=200.0, mesh=mesh)
    if service.is_leader:
        outs = [None] * len(SERVICE_PROMPTS)
        threads = [threading.Thread(target=lambda i=i, p=p: outs.__setitem__(
            i, service.submit(p, length=6, temperature=0.0)))
            for i, p in enumerate(SERVICE_PROMPTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        service.close()
        results["service"] = outs
        results["service_batches"] = service.batch_sizes
    else:
        service.wait_closed(timeout=60)
    torch.save(results, work / f"rank{rank}.pt")


# ------------------------------------------------------------------ JAX side
def _jax_state(trainer, params, extra_vars=None):
    """``trainer.init_state`` from given parameters, laid out on its mesh as
    it lays them out: by their logical annotations where the model axis is
    above 1, replicated otherwise. (The Flax init itself runs the interpreted
    flash kernel once per mesh, which is all this skips.)"""
    import jax
    import jax.numpy as jnp

    from composer_tpu.parallel import mesh as jax_mesh_lib
    from composer_tpu.train.trainer import TrainState

    mesh = trainer.mesh
    replicated = jax_mesh_lib.replicated_sharding(mesh)
    extra_vars = jax.device_put(extra_vars or {}, replicated)
    if dict(zip(mesh.axis_names, mesh.devices.shape))["model"] > 1:
        specs = jax_mesh_lib.infer_param_logical_specs(trainer.model, BATCH,
                                                       TF["window_size"])
        params = jax_mesh_lib.shard_params(params, mesh, specs)
    else:
        params = jax.device_put(params, replicated)
    # Adam's moments laid out like their weights and its counts replicated,
    # where the first step leaves them (init_state leaves them on one
    # device), so that the step compiles once.
    layout = jax.tree_util.tree_structure(params)
    shardings = jax.tree_util.tree_map(lambda leaf: leaf.sharding, params)

    def place(node):
        if jax.tree_util.tree_structure(node) == layout:
            return jax.device_put(node, shardings)
        return jax.device_put(node, replicated)

    opt_state = jax.tree_util.tree_map(
        place, jax.jit(trainer.optimizer.init)(params),
        is_leaf=lambda node: jax.tree_util.tree_structure(node) == layout)
    return TrainState(step=jax.device_put(jnp.ones((), jnp.int32), replicated),
                      epoch=jax.device_put(jnp.ones((), jnp.int32), replicated),
                      params=params, opt_state=opt_state, extra_vars=extra_vars)


def _jax_transformer_run(init, shape):
    """The JAX Trainer on a ``shape`` mesh from ``init``: losses and final
    params."""
    import jax

    from composer_tpu.data.loader import WindowDataset as JaxWindowDataset
    from composer_tpu.models import ModelType as JaxModelType
    from composer_tpu.models.transformer import Transformer as JaxTransformer
    from composer_tpu.models.transformer import TransformerConfig as JaxConfig
    from composer_tpu.parallel import create_mesh as jax_mesh
    from composer_tpu.train.trainer import Trainer as JaxTrainer

    stream = _stream(1, STEPS, BATCH, TF["window_size"], TF["vocab_size"])
    trainer = JaxTrainer(JaxTransformer(JaxConfig(**TF)), JaxModelType.TRANSFORMER, LR,
                         mesh=jax_mesh(*shape), gradient_clip_norm=CLIP)
    state = _jax_state(trainer, init)
    losses = []
    for x, y in JaxWindowDataset(stream, BATCH, TF["window_size"], shuffle=False):
        xp, yp = trainer._place_batch(x, y)
        state, metrics, _ = trainer.train_step(state, xp, yp, jax.random.PRNGKey(0), None)
        losses.append(float(metrics["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


def _jax_rnn_run(init):
    """The JAX Trainer's MusicRNN on (2, 1) from ``init`` (params, batch
    statistics): losses and final (params, batch statistics)."""
    import jax

    from composer_tpu.data.loader import WindowDataset as JaxWindowDataset
    from composer_tpu.models import ModelType as JaxModelType
    from composer_tpu.models.music_rnn import MusicRNN as JaxMusicRNN
    from composer_tpu.models.music_rnn import MusicRNNConfig as JaxConfig
    from composer_tpu.parallel import create_mesh as jax_mesh
    from composer_tpu.train.trainer import Trainer as JaxTrainer

    trainer = JaxTrainer(JaxMusicRNN(JaxConfig(**RNN)), JaxModelType.MUSIC_RNN, LR,
                         mesh=jax_mesh(2, 1), gradient_clip_norm=CLIP)
    state = _jax_state(trainer, init[0], {"batch_stats": init[1]})
    carry = trainer.init_rnn_carry(BATCH)
    losses = []
    stream = _stream(2, STEPS, BATCH, RNN_WINDOW, RNN["vocab_size"])
    for x, y in JaxWindowDataset(stream, BATCH, RNN_WINDOW, shuffle=False):
        xp, yp = trainer._place_batch(x, y)
        state, metrics, carry = trainer.train_step(state, xp, yp, jax.random.PRNGKey(0),
                                                   carry)
        losses.append(float(metrics["loss"]))
    return losses, jax.device_get((state.params, state.extra_vars["batch_stats"]))


def _jax_flash():
    import jax
    import jax.numpy as jnp

    from composer_tpu.ops.pallas_attention import sharded_relative_flash_attention
    from composer_tpu.parallel import create_mesh as jax_mesh

    mesh = jax_mesh(2, 2)

    def loss(q, k, v, e):
        out = sharded_relative_flash_attention(q, k, v, e, mesh=mesh)
        return jnp.sum(out * out), out

    inputs = tuple(jnp.asarray(t) for t in _flash_inputs())
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *inputs)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _checkpoint(directory: Path, model, model_type, state_dict) -> None:
    """A single-device checkpoint of ``state_dict`` with a fresh Adam state."""
    from composer_tpu_torch.train.checkpoint import CheckpointManager
    from composer_tpu_torch.train.trainer import Trainer

    trainer = Trainer(model, model_type, LR, device="cpu")
    state = trainer.init_state(BATCH, 1)
    state.model.load_state_dict(state_dict)
    CheckpointManager(directory).save(0, state.state_dict())


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Writes the inputs, starts the ranks and the JAX runs, then collects
    their results."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models.convert import params_to_flax, rnn_params_to_flax
    from composer_tpu_torch.models.music_rnn import MusicRNN, MusicRNNConfig
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig

    work = tmp_path_factory.mktemp("mesh")
    # One init (the Flax initializers, from a seed) for both packages.
    inits = {}
    for name, model, model_type, to_flax in (
            ("tf", Transformer(TransformerConfig(**TF)), ModelType.TRANSFORMER,
             lambda sd: params_to_flax(sd, TransformerConfig(**TF))),
            ("rnn", MusicRNN(MusicRNNConfig(**RNN)), ModelType.MUSIC_RNN,
             lambda sd: rnn_params_to_flax(sd, MusicRNNConfig(**RNN)))):
        model.reset_parameters(torch.Generator().manual_seed(0))
        _checkpoint(work / f"{name}_init", model, model_type, model.state_dict())
        with open(work / f"{name}_init.pkl", "wb") as handle:
            pickle.dump(to_flax(model.state_dict()), handle)
    gen_model = Transformer(TransformerConfig(**GEN))
    gen_model.reset_parameters(torch.Generator().manual_seed(7))
    torch.save(gen_model.state_dict(), work / "gen.pt")

    # The ranks, and a JAX process for each mesh's Trainer run (their
    # tracing is Python and would take turns in one process), each on one
    # XLA thread; the flash and MusicRNN runs meanwhile here.
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"}
    runs = [f"tf_{d}x{m}" for d, m in MESHES]
    commands = [[str(rank)] for rank in range(WORLD)] + [["jax", run] for run in runs]
    processes = [subprocess.Popen([sys.executable, __file__, *args, str(work)], cwd=REPO,
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for args in commands]
    try:
        flash = _jax_flash()
        with open(work / "rnn_init.pkl", "rb") as handle:
            rnn = _jax_rnn_run(pickle.load(handle))
        logs = [process.communicate(timeout=RANK_TIMEOUT_S)[0] for process in processes]
    finally:
        for process in processes:
            if process.poll() is None:
                process.kill()
                process.wait()
    codes = [process.returncode for process in processes]
    assert codes == [0] * len(processes), "\n".join(
        f"{' '.join(args)} (exit code {code}):\n{log[-3000:]}"
        for args, code, log in zip(commands, codes, logs))
    jax_runs = {}
    for run in runs:
        with open(work / f"jax_{run}.pkl", "rb") as handle:
            jax_runs[run] = pickle.load(handle)
    jax_runs["rnn_2x1"] = rnn
    results = [torch.load(work / f"rank{rank}.pt", weights_only=False) for rank in range(WORLD)]
    return {"work": work, "ranks": results, "jax": jax_runs, "flash": flash,
            "gen": gen_model}


# ------------------------------------------------------------------ tests
def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale, err_msg=name)


def _losses(logdir: Path) -> list:
    import json

    lines = (logdir / "train" / "metrics.jsonl").read_text().splitlines()
    return [record["value"] for record in map(json.loads, lines) if record["name"] == "loss"]


def test_sharded_flash_matches_jax(mesh_runs):
    """Each rank's block of O, dq, dk and dv against JAX's
    sharded_relative_flash_attention on (2, 2); the rank-local dE of one
    model coordinate summed over the data coordinates."""
    out, (dq, dk, dv, de) = mesh_runs["flash"]
    b, h = FLASH_SHAPE[0] // 2, FLASH_SHAPE[1] // 2
    for rank, result in enumerate(mesh_runs["ranks"]):
        d, m = divmod(rank, 2)
        rows, heads = slice(d * b, (d + 1) * b), slice(m * h, (m + 1) * h)
        _close(result["flash"]["out"], out[rows, heads], FLASH_OUT_TOL, f"O rank {rank}")
        for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            _close(result["flash"][name], want[rows, heads], FLASH_GRAD_TOL, f"{name} {rank}")
    for m in range(2):
        summed = sum(mesh_runs["ranks"][d * 2 + m]["flash"]["de"] for d in range(2))
        _close(summed, de[m * h:(m + 1) * h], FLASH_GRAD_TOL, f"dE model {m}")


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_trainer_matches_the_jax_mesh(mesh_runs, shape):
    """3 steps (relative attention, flash, clipping) on the same mesh shape:
    losses and final parameters, the port's from its gathered checkpoint."""
    from composer_tpu_torch.models.convert import params_from_flax
    from composer_tpu_torch.models.transformer import TransformerConfig
    from composer_tpu_torch.train.checkpoint import CheckpointManager

    jax_losses, jax_params = mesh_runs["jax"][f"tf_{shape[0]}x{shape[1]}"]
    logdir = mesh_runs["work"] / f"tf_{shape[0]}x{shape[1]}"
    losses = _losses(logdir)
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    saved = CheckpointManager(logdir).restore()
    assert saved["step"] == STEPS + 1
    want = params_from_flax(jax_params, TransformerConfig(**TF))
    for name, tensor in want.items():
        _close(saved["params"][name].numpy(), tensor.numpy(), PARAM_TOL, name)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_checkpoint_round_trip(mesh_runs, shape):
    """The mesh's checkpoint, restored on one device, equals gather_params
    bit for bit, and restored on the mesh gives every rank its live slices
    (weights and Adam moments) bit for bit."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.train.trainer import Trainer

    logdir = mesh_runs["work"] / f"tf_{shape[0]}x{shape[1]}"
    single = Trainer(Transformer(TransformerConfig(**TF)), ModelType.TRANSFORMER, LR,
                     device="cpu").restore(logdir, BATCH, TF["window_size"])
    members = [r[shape] for r in mesh_runs["ranks"] if shape in r]
    (leader,) = [m for m in members if m["leader"]]
    for name, tensor in single.model.state_dict().items():
        assert torch.equal(tensor, leader["gathered"][name]), name
    assert len(members) == shape[0] * shape[1]
    assert all(m["restored_equal"] and m["step"] == STEPS + 1 for m in members)


def test_music_rnn_data_parallel_matches_jax(mesh_runs):
    """MusicRNN with BatchNorm on (2, 1): losses, running statistics (of the
    global batch) and weights after 3 steps."""
    from composer_tpu_torch.models.convert import rnn_params_from_flax
    from composer_tpu_torch.models.music_rnn import MusicRNNConfig
    from composer_tpu_torch.train.checkpoint import CheckpointManager

    jax_losses, (params, stats) = mesh_runs["jax"]["rnn_2x1"]
    logdir = mesh_runs["work"] / "rnn_2x1"
    np.testing.assert_allclose(_losses(logdir), jax_losses, rtol=LOSS_RTOL)
    saved = CheckpointManager(logdir).restore()["params"]
    want = rnn_params_from_flax(params, stats, MusicRNNConfig(**RNN))
    for name, tensor in want.items():
        _close(saved[name].numpy(), tensor.numpy(), PARAM_TOL, name)
    assert mesh_runs["ranks"][0]["rnn"]["restored_equal"]


def test_greedy_generation_matches_single_device(mesh_runs):
    """generate_ids on the (2, 2) mesh (tensor parallel, rows split over the
    data axis) gives the single-device ids, on every rank."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.train.generate import generate_ids

    prompts = np.random.default_rng(3).integers(0, GEN["vocab_size"], (8, 4))
    single = generate_ids(mesh_runs["gen"], ModelType.TRANSFORMER, None, prompts, length=16,
                          temperature=0.0, engine="xla")
    for rank, result in enumerate(mesh_runs["ranks"]):
        np.testing.assert_array_equal(result["greedy"], single, err_msg=f"rank {rank}")


def test_mesh_service_matches_single_device_service(mesh_runs):
    """GenerationService(mesh=) on (2, 2): the ragged batch of 4 greedy
    requests gives the single-device service's responses."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.serving import GenerationService

    service = GenerationService(mesh_runs["gen"], ModelType.TRANSFORMER, None,
                                GEN["vocab_size"], max_batch_size=4, max_wait_ms=200.0,
                                device="cpu")
    try:
        want = [service.submit(p, length=6, temperature=0.0) for p in SERVICE_PROMPTS]
    finally:
        service.close()
    leader = mesh_runs["ranks"][0]
    assert sum(leader["service_batches"]) == len(SERVICE_PROMPTS)
    for got, expected in zip(leader["service"], want):
        np.testing.assert_array_equal(got, expected)


def test_sampled_ids_agree_across_a_model_group(mesh_runs):
    """Sampling draws the same ids on the ranks of a model group (their
    logits are equal), and the data coordinates' rows are their own."""
    ranks = mesh_runs["ranks"]
    np.testing.assert_array_equal(ranks[0]["sampled"], ranks[1]["sampled"])
    np.testing.assert_array_equal(ranks[2]["sampled"], ranks[3]["sampled"])
    np.testing.assert_array_equal(ranks[0]["sampled"], ranks[2]["sampled"])
    assert ranks[0]["sampled"].shape == (4, 20)


def test_indivisible_shapes_raise_with_the_jax_messages():
    """The cuts that do not divide: heads at construction, batch rows where
    a rank takes them (no ranks needed)."""
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.parallel import Mesh, local_rows

    mesh = Mesh(data=2, model=3, rank=0, data_index=0, model_index=0, ranks=tuple(range(6)),
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="heads 2 not divisible by model=3"):
        Transformer(TransformerConfig(**{**TF, "flash_mesh": mesh}))
    with pytest.raises(ValueError, match="batch 3 not divisible by data=2"):
        local_rows(mesh, np.zeros((3, 8)))


def _jax_main(run: str, work: Path) -> None:
    """One mesh's JAX Trainer run (``tf_<data>x<model>``), configured as
    tests/conftest.py configures JAX."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_default_matmul_precision", "highest")
    shape = run.split("_")[1]
    with open(work / "tf_init.pkl", "rb") as handle:
        init = pickle.load(handle)
    result = _jax_transformer_run(init, tuple(int(n) for n in shape.split("x")))
    with open(work / f"jax_{run}.pkl", "wb") as handle:
        pickle.dump(result, handle)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2], Path(sys.argv[3]))
    else:
        _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
