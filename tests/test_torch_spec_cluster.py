"""The speculative kernel's cluster layout and admission, its cluster-size
query, and the corpus generator of ``scripts/spec_acceptance.py`` (CPU).

``spec_kernel_fits`` admits a (cache, block) by the budget of the kernel's
first, one-block layout, and routing follows it; the cluster kernel must fit
every admitted case at every cluster size the launch can take
(``spec_cluster_passes`` picks a block's head and row passes,
``spec_cluster_smem_bytes`` mirrors ``rows_smem_floats`` in
csrc/decode_cluster_rows.cuh). The corpus generator is a copy written
against the port's ``NoteSequence``; it must give the original's notes.
"""

import importlib.util
import random
from pathlib import Path

import pytest
import torch

from composer_tpu_torch.models.transformer import TransformerConfig
from composer_tpu_torch.ops import _build
from composer_tpu_torch.ops import decode_kernel_batched as dkb
from composer_tpu_torch.ops import decode_kernel_spec as dks

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = TransformerConfig(vocab_size=390)
# The largest cache the admission takes at each block for the default model,
# as before the cluster kernel (blocks 13-16 fit no cache at these widths).
LARGEST_ADMITTED = {2: 2808, 3: 2671, 4: 2535, 5: 2338, 6: 2141, 7: 1944, 8: 1748, 9: 1551,
                    10: 1354, 11: 1157, 12: 144}


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("block,largest", sorted(LARGEST_ADMITTED.items()))
def test_admission_is_unchanged(block, largest):
    assert dks.spec_kernel_fits(DEFAULT, largest, block)
    assert not dks.spec_kernel_fits(DEFAULT, largest + 1, block)


def test_admission_at_cache_2048_is_unchanged():
    fits = [block for block in range(dks.SPEC_BLOCK_MIN, dks.SPEC_BLOCK_MAX + 1)
            if dks.spec_kernel_fits(DEFAULT, 2048, block)]
    assert fits == [2, 3, 4, 5, 6]
    assert not any(dks.spec_kernel_fits(DEFAULT, 1, block) for block in (13, 16))


@pytest.mark.parametrize("block", sorted(LARGEST_ADMITTED))
@pytest.mark.parametrize("cluster", [16, 8, 4, 2, 1])
def test_cluster_layout_fits_every_admitted_cache(cluster, block):
    """At every cluster size ``cluster_size`` can return for 16 heads, the
    layout at the chosen passes fits the card's shared memory for the
    largest admitted cache, and so (the layout grows with the cache) for
    every smaller one; a coarse sweep checks the smaller ones too."""
    largest = LARGEST_ADMITTED[block]
    for cache_len in sorted({largest, *range(16, largest, 97)}):
        passes = dks.spec_cluster_passes(DEFAULT, cache_len, block, cluster)
        assert passes is not None, (cache_len, block, cluster)
        heads, rows = passes
        assert (DEFAULT.num_heads // cluster) % heads == 0 and 1 <= rows <= dks.ROW_CHUNK
        used = dks.spec_cluster_smem_bytes(DEFAULT, cache_len, block, cluster)
        assert used == dks.spec_cluster_smem_bytes(DEFAULT, cache_len, block, cluster, passes)
        assert used <= dks.MAX_SHARED_BYTES, (cache_len, block, cluster, passes, used)


def test_cluster_passes_of_the_main_path():
    """G = 16 (the default model at batch 1): a block owns one head, and a
    verify block's rows share one pass over the weights up to ROW_CHUNK."""
    assert dks.spec_cluster_passes(DEFAULT, 1024, 5, 16) == (1, 5)
    assert dks.spec_cluster_passes(DEFAULT, 1024, 3, 16) == (1, 3)
    assert dks.spec_cluster_passes(DEFAULT, 1157, 11, 16) == (1, 8)
    # Fewer blocks hold more heads: passes of fewer heads (and rows) fit.
    assert dks.spec_cluster_passes(DEFAULT, 2338, 5, 1) == (2, 5)
    assert dks.spec_cluster_passes(DEFAULT, 1157, 11, 1) == (1, 5)
    # No cluster size that leaves a block part of a head or of a logits group.
    assert dks.spec_cluster_passes(DEFAULT, 1024, 5, 32) is None
    assert dks.spec_cluster_passes(TransformerConfig(vocab_size=390, num_heads=4, embed_dim=64),
                                   128, 5, 8) is None


def test_cluster_size_query_takes_the_passes(monkeypatch):
    """``launch_cluster_size`` hands the speculative kernel's occupancy query
    its block and passes at each G, counts a G the layout cannot take as no
    resident cluster, and picks G by ``cluster_size``."""
    calls = []

    class Library:
        @staticmethod
        def spec_decode_clusters(*args):
            calls.append(args[:-1])
            args[-1]._obj.value = 1 if args[2] in (8, 4, 2) else 0
            return 0

    monkeypatch.setattr(_build, "load_library", lambda name: Library)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: type("Props", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(dkb, "_MAX_ACTIVE", {})

    def extra(g):
        passes = dks.spec_cluster_passes(DEFAULT, 1024, 5, g)
        return None if g == 4 or passes is None else (5, *passes)

    cluster = dkb.launch_cluster_size("spec_decode", DEFAULT, 1, 1029, torch.bfloat16,
                                      torch.device("cuda", 0), extra)
    assert cluster == 8  # 16 has no resident cluster here
    assert [call[2] for call in calls] == [16, 8, 2]  # G = 4 was never asked
    assert calls[0] == (1, 0, 16, 256, 16, 16, 1029, 512, 5, 1, 5)
    assert calls[1][8:] == (5, *dks.spec_cluster_passes(DEFAULT, 1024, 5, 8))


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_corpus_generator_copy_gives_the_original_notes(seed):
    ours = _module(ROOT / "scripts" / "spec_acceptance.py", "spec_acceptance")
    theirs = _module(ROOT / "data" / "scripts" / "make_synthetic_corpus.py",
                     "make_synthetic_corpus")
    a, b = ours.make_piece(random.Random(seed)), theirs.make_piece(random.Random(seed))
    assert [(n.start, n.end, n.pitch, n.velocity) for n in a.notes] == \
        [(n.start, n.end, n.pitch, n.velocity) for n in b.notes]
    assert [(p.start, p.end) for p in a.sustain_periods] == \
        [(p.start, p.end) for p in b.sustain_periods]
    assert len(a.notes) > 50
