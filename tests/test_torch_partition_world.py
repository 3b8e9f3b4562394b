"""The partitioned mines of every engine over a world of ranks.

One 4-rank gloo world of CPU ranks is spawned for the module
(``parallel.launch.spawn_world``), and every rank runs every case of
``_torch_partition_worker.CASES`` at ``partition_parts=2`` (two rows of
two ranks: each row's engines all-reduce inside the row) and at
``partition_parts=4`` (rows of one rank: the bare route).  For each case
and layout it checks that:

- every rank's text equals the reference's ``partition_parts=2`` mine on
  ``make_mesh(8)`` (the 8 virtual CPU devices ``tests/conftest.py`` sets
  up), run here, and the port's mine in one process without a mesh;
- a row's group has ``inner`` ranks, and the only collective that spans
  more than one row is the exchange: one a deepening round for TSR, one a
  mine for the others, exactly ``partition_exchanges`` (and counted so by
  ``partition.tallies``);
- the ranks of a row agree on the stats, and every rank on the exchanged
  bytes.

A 3-rank world at ``partition_parts=2`` raises the reference's error.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

import _torch_partition_worker as W
from spark_fsm_tpu.models.spade_constrained import mine_cspade_tpu
from spark_fsm_tpu.models.spade_tpu import mine_spade_tpu
from spark_fsm_tpu.models.spam_bitmap import mine_spam_tpu
from spark_fsm_tpu.models.tsr import mine_tsr_tpu
from spark_fsm_tpu.parallel.mesh import make_mesh
from spark_fsm_tpu.utils.canonical import patterns_text as j_patterns_text
from spark_fsm_tpu.utils.canonical import rules_text as j_rules_text
from spark_fsm_tpu_torch.parallel.launch import spawn_world

WORLD = 4
PARTS = (2, 4)
NAMES = tuple(W.CASES)


def run_reference(name: str, mesh) -> str:
    """The reference's ``partition_parts=2`` mine of case ``name``."""
    algo, db, kw = W.case_input(name)
    if algo == "tsr":
        k, minconf = kw.pop("k"), kw.pop("minconf")
        return j_rules_text(mine_tsr_tpu(db, k, minconf, mesh=mesh,
                                         partition_parts=2, **kw))
    minsup = kw.pop("minsup")
    fn = {"spade": mine_spade_tpu, "spam": mine_spam_tpu,
          "cspade": mine_cspade_tpu}[algo]
    return j_patterns_text(fn(db, minsup, mesh=mesh, partition_parts=2,
                              **kw))


@pytest.fixture(scope="module")
def world():
    """Each rank's results, the reference's texts and the port's
    single-process results; the worlds run while this process mines."""
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(spawn_world, W.run_cases, WORLD, "gloo", "cpu",
                            (PARTS,), threads=1, timeout_s=600)
        refused = pool.submit(spawn_world, W.refuse_parts, 3, "gloo", "cpu",
                              (2,), threads=1, timeout_s=300)
        mesh = make_mesh(8)
        ref = {name: run_reference(name, mesh) for name in NAMES}
        one = {(name, parts): W.run_port(name, parts)
               for name in NAMES for parts in PARTS}
        return ref, one, ranks.result(), refused.result()


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", NAMES)
def test_world_mine_equals_reference_and_one_process(world, name, parts):
    ref, one, ranks, _ = world
    inner = WORLD // parts
    want = ref[name]
    assert want and one[(name, parts)]["text"] == want
    for rank in ranks:
        res = rank[(name, parts)]
        stats = res["stats"]
        assert res["text"] == want, rank["rank"]
        if name.startswith("tsr"):
            assert stats["partition_owned"] == [rank["rank"] // inner]
        # the only collective that spans rows is the exchange
        spans = [n for n, size in res["collectives"] if size > inner]
        assert spans == ["all_gather_object"] * stats["partition_exchanges"]
        assert res["world_collectives"] == stats["partition_exchanges"]
        if name.startswith("tsr"):
            assert stats["partition_exchanges"] == stats["deepening_rounds"]
        else:
            assert stats["partition_exchanges"] == 1
        in_row = [n for n, size in res["collectives"] if size == inner]
        # a row of several ranks all-reduces inside itself; a row of one
        # runs the bare route and makes no collective of its own
        assert bool(in_row) == (inner > 1)
        assert (stats["partition_cross_bytes"]
                == ranks[0][(name, parts)]["stats"]["partition_cross_bytes"])
        # the ranks of a row ran the same slice (the counter waits are
        # each rank's own clock)
        leader = ranks[rank["rank"] - rank["rank"] % inner][(name, parts)]
        assert ({k: v for k, v in stats.items() if k != "wait_s"}
                == {k: v for k, v in leader["stats"].items()
                    if k != "wait_s"})


@pytest.mark.parametrize("parts", PARTS)
def test_row_groups_have_inner_ranks(world, parts):
    _, _, ranks, _ = world
    inner = WORLD // parts
    for rank in ranks:
        rows = rank["rows"][parts]
        own = rank["rank"] // inner
        assert len(rows) == parts
        assert rows[own] == (inner if inner > 1 else None)
        assert all(r is None for p, r in enumerate(rows) if p != own)


def test_world_that_parts_do_not_divide_raises(world):
    *_, refused = world
    assert len(refused) == 3
    for msg in refused:
        assert "mesh of 3 devices does not split into 2 equal" in msg
