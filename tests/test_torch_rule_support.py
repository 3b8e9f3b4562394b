"""Port parity for the rule-support kernel's module (TSR): the plain PyTorch
version against the Pallas kernel (interpret mode, as the JAX package's own
tests run it on the CPU) and against the reference's jnp evaluator, exactly,
and the wrapper's device rules: plain version only for CPU tensors, a raise
for anything it cannot launch.

The port reads flat ``[M+1, S*W]`` (word minor) stores with the all-ones
pad row last; the Pallas kernel takes the folded ``[M+1, S/128, 128]`` /
``[M+1, W, S/128, 128]`` layout and the jnp evaluator ``[M, S, W]``, so the
tests lay the same words out for each."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_fsm_tpu.models import tsr as JT
from spark_fsm_tpu.ops import pallas_tsr as JPT
from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.interop import tsr_prep_from_numpy
from spark_fsm_tpu_torch.models.tsr import TsrCPU, TsrTorch
from spark_fsm_tpu_torch.ops import _build
from spark_fsm_tpu_torch.ops import rule_support as RS


def _words(rng, *shape):
    w = (rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32))
    return w | (rng.integers(0, 2, shape, dtype=np.uint32) << np.uint32(31))


def _xy(rng, C, km, n_rows, empty_side=None):
    """[C, 2, km] candidates with 1..km distinct rows a side, -1 elsewhere;
    ``empty_side`` leaves one side all -1 (the all-ones pad row)."""
    xy = np.full((C, 2, km), -1, np.int32)
    for c in range(C):
        for side in (0, 1):
            if side == empty_side:
                continue
            n = rng.integers(1, km + 1)
            xy[c, side, :n] = rng.choice(n_rows, n, replace=False)
    return xy


def _flat(rows):
    """[n, S, W] uint32 engine rows -> the port's padded flat int32 store."""
    return tsr_prep_from_numpy(rows, rows, device="cpu")[0]


def _fold(rows):
    """[n, S, W] engine rows -> the Pallas kernel's folded layout, pad row
    appended (as tests/test_pallas_tsr.py builds it)."""
    k = rows.transpose(0, 2, 1)
    k = np.concatenate([k, np.full((1,) + k.shape[1:], 0xFFFFFFFF, np.uint32)])
    n, W, S = k.shape
    return k.reshape(n, S // 128, 128) if W == 1 else k.reshape(n, W, S // 128, 128)


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("km", [1, 2, 4])
def test_plain_matches_pallas_interpret(W, km):
    rng = np.random.default_rng(10 * W + km)
    sb = JPT.seq_block(W, 8 * 128)
    S, n_rows, C = 2 * sb, 9, JPT.C_LANES          # two sequence blocks
    p = _words(rng, n_rows, S, W)
    s = _words(rng, n_rows, S, W)
    xy = _xy(rng, C, km, n_rows)
    want = np.asarray(JPT.rule_supports(
        jnp.asarray(_fold(p)), jnp.asarray(_fold(s)), jnp.asarray(xy),
        km=km, s_block=sb, interpret=True))
    got = RS.rule_supports_plain(_flat(p), _flat(s), torch.from_numpy(xy),
                                 n_words=W)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, C)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W,km,empty_side", [(1, 1, None), (1, 2, None),
                                             (2, 4, None), (3, 2, 0),
                                             (2, 2, 1)])
def test_plain_matches_jnp_evaluator(W, km, empty_side):
    rng = np.random.default_rng(30 + 7 * W + km)
    S, n_rows, C = 301, 11, 77
    p = _words(rng, n_rows, S, W)
    s = _words(rng, n_rows, S, W)
    xy = _xy(rng, C, km, n_rows, empty_side)
    want = np.asarray(JT._eval_kernel(None, km)(
        jnp.asarray(p), jnp.asarray(s), jnp.asarray(xy)))
    got = RS.rule_supports_plain(_flat(p), _flat(s), torch.from_numpy(xy),
                                 n_words=W)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(seed=3, n_sequences=90, n_items=14, mean_itemsets=5.0),
    dict(seed=8, n_sequences=40, n_items=8, mean_itemsets=40.0,
         max_itemsets=80),                          # W >= 2
])
def test_engine_prep_and_plain_match_numpy_fold(kw):
    # the engine's torch prep against TsrCPU's numpy prep, and a ragged
    # batch (C = 77, not a multiple of 128) through the plain version
    # against TsrCPU's numpy fold
    vdb = build_vertical(synthetic_db(**kw), min_item_support=1)
    m = vdb.n_items
    cpu = TsrCPU(vdb, 5, 0.5)
    eng = TsrTorch(vdb, 5, 0.5, device="cpu")
    pn, sn = cpu._prep(m)
    p1, s1 = eng._prep(m)
    assert torch.equal(p1, _flat(pn)) and torch.equal(s1, _flat(sn))
    rng = np.random.default_rng(5)
    cands = []
    for _ in range(77):
        nx, ny = rng.integers(1, 3, 2)
        items = rng.choice(m, nx + ny, replace=False).tolist()
        cands.append((tuple(items[:nx]), tuple(items[nx:])))
    xy = np.full((77, 2, 2), -1, np.int32)
    for c, (x, y) in enumerate(cands):
        xy[c, 0, :len(x)], xy[c, 1, :len(y)] = x, y
    got = RS.rule_supports_plain(p1, s1, torch.from_numpy(xy),
                                 n_words=vdb.n_words).numpy()
    sup, supx = cpu._dispatch_eval(pn, sn, cands)
    np.testing.assert_array_equal(got, np.stack([sup, supx]))


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(3)
    p, s = _words(rng, 6, 45, 3), _words(rng, 6, 45, 3)
    xy = torch.from_numpy(_xy(rng, 10, 2, 6))
    before = RS.rule_supports.launches
    got = RS.rule_supports(_flat(p), _flat(s), xy, n_words=3)
    assert torch.equal(got, RS.rule_supports_plain(_flat(p), _flat(s), xy,
                                                   n_words=3))
    assert RS.rule_supports.launches == before


def test_plain_chunking_is_exact(monkeypatch):
    rng = np.random.default_rng(4)
    p1, s1 = _flat(_words(rng, 7, 50, 2)), _flat(_words(rng, 7, 50, 2))
    xy = torch.from_numpy(_xy(rng, 33, 4, 7))
    whole = RS.rule_supports_plain(p1, s1, xy, n_words=2)
    monkeypatch.setattr(RS, "_CHUNK_BYTES", 1)      # one candidate a chunk
    assert torch.equal(whole, RS.rule_supports_plain(p1, s1, xy, n_words=2))


def test_wrapper_never_quietly_uses_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(RS, "rule_supports_plain",
                        lambda *a, **k: calls.append(1))
    p = torch.zeros(3, 32, dtype=torch.int32, device="meta")
    xy = torch.zeros(4, 2, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        RS.rule_supports(p, p, xy)
    assert calls == []


def test_kernel_request_raises_on_a_box_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the kernel path runs instead")
    if _build.shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            RS._kernel()
    with pytest.raises(ValueError, match="use_kernel"):
        TsrTorch(build_vertical([((1,), (2,))]), 1, 0.5, device="cpu",
                 use_kernel=True)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "width", "xy",
                                 "device"])
def test_wrapper_rejects_bad_operands(bad):
    p1 = torch.zeros(4, 64, dtype=torch.int32)
    s1 = torch.zeros(4, 64, dtype=torch.int32)
    xy = torch.zeros(5, 2, 2, dtype=torch.int32)
    w = 2
    if bad == "dtype":
        p1 = p1.to(torch.int64)
    elif bad == "shape":
        s1 = torch.zeros(3, 64, dtype=torch.int32)
    elif bad == "contig":
        xy = torch.zeros(2, 2, 5, dtype=torch.int32).permute(2, 1, 0)
    elif bad == "width":
        w = 3
    elif bad == "xy":
        xy = torch.zeros(5, 3, 2, dtype=torch.int32)
    elif bad == "device":
        s1 = s1.to("meta")
    with pytest.raises((TypeError, ValueError)):
        RS.rule_supports(p1, s1, xy, n_words=w)
