"""Port parity for the pair-support kernel's module: the plain PyTorch
version against the Pallas kernel (interpret mode, as the JAX package's own
tests run it on the CPU), W = 1 and W = 2, and the wrapper's device rules:
plain version only for CPU tensors, a raise for anything it cannot launch.

The port reads the engine's flat ``[rows, S*W]`` (word minor) layout; the
Pallas kernel takes ``[rows, W, S]``, so the tests transpose for it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_fsm_tpu.ops import pallas_support as JPS
from spark_fsm_tpu_torch.ops import _build
from spark_fsm_tpu_torch.ops import pair_support as PS


def _words(rng, *shape):
    w = (rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32))
    return w | (rng.integers(0, 2, shape, dtype=np.uint32) << np.uint32(31))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("n_words", [1, 2])
def test_pair_supports_plain_matches_pallas(n_words):
    rng = np.random.default_rng(10 + n_words)
    sb = JPS.seq_block(n_words)
    P, NI, S, W = 2 * JPS.P_TILE, 21, sb, n_words
    pt = _words(rng, P, S, W)                       # engine layout [P, S, W]
    items = _words(rng, JPS.I_TILE, S, W)
    want = np.asarray(JPS.pair_supports(
        jnp.asarray(pt.transpose(0, 2, 1)), jnp.asarray(items.transpose(0, 2, 1)),
        NI, s_block=sb, interpret=True))[:, :NI]
    got = PS.pair_supports_plain(_t(pt.reshape(P, -1)),
                                 _t(items.reshape(len(items), -1)), NI,
                                 n_words=W)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P, NI)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_words", [1, 2])
def test_batch_supports_plain_matches_pallas(n_words):
    rng = np.random.default_rng(20 + n_words)
    sb = JPS.seq_block(n_words)
    P, NI, S, W = 20, 37, sb, n_words               # P off the Pallas tile
    pt = _words(rng, P, S * W)
    items = _words(rng, JPS.I_TILE, S * W)
    pref = rng.integers(0, P, 60).astype(np.int32)
    item = rng.integers(0, NI, 60).astype(np.int32)
    want = np.asarray(JPS.batch_supports(
        jnp.asarray(pt), jnp.asarray(items), NI, jnp.asarray(pref),
        jnp.asarray(item), s_block=sb, interpret=True, n_words=W))
    got = PS.batch_supports_plain(_t(pt), _t(items), NI,
                                  torch.from_numpy(pref).long(),
                                  torch.from_numpy(item).long(), n_words=W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(3)
    pt, items = _t(_words(rng, 7, 3 * 45)), _t(_words(rng, 11, 3 * 45))
    before = PS.pair_supports.launches
    got = PS.pair_supports(pt, items, 9, n_words=3)
    assert torch.equal(got, PS.pair_supports_plain(pt, items, 9, n_words=3))
    pref, item = torch.tensor([0, 6, 3]), torch.tensor([8, 0, 4])
    assert torch.equal(PS.batch_supports(pt, items, 9, pref, item, n_words=3),
                       got[pref, item])
    assert PS.pair_supports.launches == before


def test_plain_chunking_is_exact(monkeypatch):
    rng = np.random.default_rng(4)
    pt, items = _t(_words(rng, 13, 2 * 50)), _t(_words(rng, 6, 2 * 50))
    whole = PS.pair_supports_plain(pt, items, 6, n_words=2)
    monkeypatch.setattr(PS, "_CHUNK_BYTES", 1)      # one parent row a chunk
    tiny = PS.pair_supports_plain(pt, items, 6, n_words=2)
    assert torch.equal(whole, tiny)


def test_wrapper_never_quietly_uses_the_plain_version(monkeypatch):
    # a tensor that is neither on the CPU nor on CUDA: the wrapper raises
    # and the plain version is not reached
    calls = []
    monkeypatch.setattr(PS, "pair_supports_plain",
                        lambda *a, **k: calls.append(1))
    pt = torch.zeros(4, 32, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        PS.pair_supports(pt, pt, 2)
    assert calls == []


def test_kernel_request_raises_on_a_box_without_cuda():
    # a CUDA request here cannot reach the plain version: torch refuses the
    # CUDA tensor, and the kernel cannot be built without nvcc
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the kernel path runs instead")
    with pytest.raises((AssertionError, RuntimeError)):
        torch.zeros(1, dtype=torch.int32, device="cuda")
    if _build.shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            PS._kernel()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "rows", "width",
                                 "device"])
def test_wrapper_rejects_bad_operands(bad):
    pt = torch.zeros(4, 64, dtype=torch.int32)
    items = torch.zeros(6, 64, dtype=torch.int32)
    n, w = 5, 2
    if bad == "dtype":
        pt = pt.to(torch.int64)
    elif bad == "shape":
        pt = pt.view(4, 32, 2)
    elif bad == "contig":
        pt = torch.zeros(64, 4, dtype=torch.int32).t()
    elif bad == "rows":
        n = 7
    elif bad == "width":
        w = 3
    elif bad == "device":
        items = items.to("meta")
    with pytest.raises((TypeError, ValueError)):
        PS.pair_supports(pt, items, n, n_words=w)
