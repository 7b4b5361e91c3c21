"""P1, the windowed gather (``orz_tpu_torch/kernels/windowed_gather.py``),
and the port's probe, on the CPU.

The plain version, which the wrapper runs on CPU tensors, is held to the
JAX package's ``tools/gather_probe.py`` ``windowed_gather`` (its Pallas
kernel in interpret mode) at m = 4 x 2048 outputs from n = 4m words (the
probe's arrays at m_log2 = 13), in four cases: ascending in-window indices,
indices at and past the window's edges (fill 0), bases above their block's
first index (negative offsets wrap) and a last block whose window runs past
the end of src (clamped).  All outputs are integers: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orz_tpu_torch.kernels import windowed_gather as wg
from orz_tpu_torch.tools import gather_probe

M_LOG2 = 13  # m = 4 x 2048


@pytest.fixture(scope="module")
def probe():
    return gather_probe.probe_data(M_LOG2)


@pytest.mark.parametrize("case", ["in_window", "fill", "wrap", "clamp"])
def test_windowed_gather_plain_matches_jax(probe, case):
    from tools.gather_probe import windowed_gather as jax_windowed_gather

    src = probe["src"]
    idx, base = gather_probe.edge_cases(probe["idx"], probe["base"],
                                        src.size)[case]
    want = np.asarray(jax_windowed_gather(jnp.asarray(src), jnp.asarray(idx),
                                          jnp.asarray(base)))
    before = wg.launches
    got = wg.windowed_gather(torch.from_numpy(src), torch.from_numpy(idx),
                             torch.from_numpy(base))
    assert wg.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.shape == (idx.size,)
    np.testing.assert_array_equal(got.numpy(), want)
    inside = src[np.clip(idx, 0, src.size - 1)]
    if case == "in_window":  # the caller's contract: src[idx]
        np.testing.assert_array_equal(want, inside)
    else:  # each edge case reaches outside that contract
        assert (want != inside).any()


@pytest.mark.parametrize("bad", ["dtype", "rank", "src_len", "src_short",
                                 "idx_len", "idx_empty", "base_len"])
def test_windowed_gather_rejects_bad_input(probe, bad):
    src, idx, base = (torch.from_numpy(probe[k]) for k in ("src", "idx",
                                                           "base"))
    if bad == "dtype":
        idx = idx.long()
    elif bad == "rank":
        src = src.view(-1, 128)
    elif bad == "src_len":
        src = src[:-1]
    elif bad == "src_short":
        src = src[:wg.WIN - 128]
    elif bad == "idx_len":
        idx = idx[:-1]
    elif bad == "idx_empty":
        idx, base = idx[:0], base[:0]
    else:
        base = base[:-1]
    with pytest.raises(ValueError):
        wg.windowed_gather(src, idx, base)


def test_probe_on_cpu_prints_ok(capsys):
    assert gather_probe.main([str(M_LOG2)], device="cpu") == 0
    out = capsys.readouterr().out
    assert f"m=2^{M_LOG2} gathers from n=4m (cpu)" in out
    for name in ("gather random", "gather sorted", "scatter sorted",
                 "take sorted"):
        assert f"torch {name}" in out
    assert "windowed gather" in out and "ok=True" in out


def test_probe_needs_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert gather_probe.main([str(M_LOG2)]) == 1
    assert "CUDA" in capsys.readouterr().err
