"""node_sums' plain version: the fixed-point sum its kernel computes.

histogram_mxu.node_sums_ref adds every value as rint(x x 2^k) in int64,
one power-of-two scale per channel from its max |x| over all n rows and n
itself (node_sums_scale: k = 61 - e - lg), and scales the sums back once,
as csrc/node_sums.cu does; the kernel holds each CTA's sums in two 32-bit
shared words, the low one carrying its wraps into the high one. Held
here: the rule computed independently in numpy, bit for bit; the JAX
package's node_sums_mxu in Pallas interpret mode, bit for bit on dyadic
inputs (whose sums are exact in any order); and the worst case of the
scale (every row in one node, |x| at the channel's max) for N from 1 to
2^24, which neither the int64 sum nor the kernel's words can overflow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _rule(node, cols, m):
    """The fixed-point rule in numpy, channel by channel."""
    n = node.shape[0]
    lg = (n - 1).bit_length() if n > 1 else 0
    keep = (node >= 0) & (node < m)
    out = np.zeros((m, 3), np.float32)
    for c, x in enumerate(cols):
        amax = np.abs(x).max() if n else np.float32(0)
        if not np.isfinite(amax):
            out[:, c] = np.nan
            continue
        k = 61 - int(np.frexp(amax)[1]) - lg
        q = np.rint(x.astype(np.float64) * 2.0 ** k).astype(np.int64)
        s = np.zeros(m, np.int64)
        np.add.at(s, node[keep], q[keep])
        out[:, c] = (s.astype(np.float64) * 2.0 ** -k).astype(np.float32)
    return out


def _rows(case, r):
    n, m = {"one_row": (1, 4), "empty": (0, 5)}.get(case, (6000, 257))
    node = r.randint(-3, m + 20, n).astype(np.int32)      # some ignored
    g = r.randn(n).astype(np.float32)
    h = r.uniform(0.01, 0.3, n).astype(np.float32)
    c = (r.rand(n) < 0.9).astype(np.float32)
    if case == "wide_range":
        g *= np.float32(10.0) ** r.randint(-30, 30, n).astype(np.float32)
    elif case == "subnormal":
        h = (r.randint(1, 1000, n) * 2.0 ** -149).astype(np.float32)
    elif case == "nan_grad":
        g[17] = np.nan
    elif case == "inf_hess":
        node[5] = -1                   # an ignored row's inf counts too
        h[5] = np.inf
    return node, (g, h, c), m


@pytest.mark.parametrize("case", ["random", "wide_range", "subnormal",
                                  "one_row", "empty", "nan_grad",
                                  "inf_hess"])
def test_node_sums_ref_is_the_fixed_point_rule(case):
    node, cols, m = _rows(case, np.random.RandomState(31))
    got = torch_k.node_sums(torch.as_tensor(node),
                            *(torch.as_tensor(x) for x in cols),
                            num_nodes=m).numpy()
    want = _rule(node, cols, m)
    assert got.shape == (m, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if case in ("nan_grad", "inf_hess"):
        bad = 0 if case == "nan_grad" else 1
        assert np.isnan(got[:, bad]).all()
        assert np.isfinite(np.delete(got, bad, axis=1)).all()


@pytest.mark.parametrize("n,m", [(1, 3), (257, 1), (4000, 510)])
def test_node_sums_matches_jax_on_dyadic_inputs(n, m):
    r = np.random.RandomState(n)
    node = r.randint(-2, m + 3, n).astype(np.int32)
    g = (r.randint(-4096, 4097, n) / 1024).astype(np.float32)
    h = (r.randint(1, 257, n) / 1024).astype(np.float32)
    c = np.ones(n, np.float32)
    want = np.asarray(jax_k.node_sums_mxu(
        jnp.asarray(node), jnp.asarray(g), jnp.asarray(h), jnp.asarray(c),
        num_nodes=m, interpret=True))
    got = torch_k.node_sums(torch.as_tensor(node), torch.as_tensor(g),
                            torch.as_tensor(h), torch.as_tensor(c),
                            num_nodes=m).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


_WORST_N = sorted({n for j in range(25) for n in (2 ** j - 1, 2 ** j,
                                                 2 ** j + 1)
                   if 1 <= n <= 2 ** 24} | set(range(1, 65)))


@pytest.mark.parametrize("amax", [1.0, float(np.nextafter(np.float32(2),
                                                          np.float32(0))),
                                  0.75, 3.4e38, 1e-30, 2.0 ** -149])
def test_node_sums_worst_case_cannot_overflow(amax):
    # every one of N rows at +-amax in one node, N from 1 to 2^24: each
    # row is at most 2^(61 - lg) and the node's int64 sum at most 2^61;
    # the kernel's two words (the low 32 bits modulo 2^32, their wraps
    # carried into the high word with q >> 32) hold that sum exactly: the
    # high word's end value fits an int32
    x = np.float32(amax)
    for n in _WORST_N:
        k = int(torch_k.node_sums_scale(
            torch.tensor([x] * 3, dtype=torch.float32), n)[0])
        lg = (n - 1).bit_length()
        q = int(float(x) * 2.0 ** k)              # exact: x has 24 bits
        assert float(q) == float(x) * 2.0 ** k
        assert 2 ** (60 - lg) <= q <= 2 ** (61 - lg)  # no bit wasted
        for qs in (q, -q):
            total = n * qs
            assert abs(total) <= 2 ** 61
            lo_sum = n * (qs & 0xffffffff)        # the low word, unwrapped
            hi = n * (qs >> 32) + (lo_sum >> 32)  # the high word + carries
            assert -2 ** 29 <= hi < 2 ** 29
            assert hi * 2 ** 32 + (lo_sum & 0xffffffff) == total
    # the plain version on such rows: the exact f32 of n x amax
    for n in (1, 2, 3, 1000, 2 ** 16 + 1, 2 ** 20):
        for sign in (1.0, -1.0):
            v = torch.full((n,), sign * x, dtype=torch.float32)
            got = torch_k.node_sums(torch.zeros(n, dtype=torch.int32), v,
                                    v, v, num_nodes=2)
            with np.errstate(over="ignore"):      # 3.4e38 x n: inf
                want = np.float32(n * sign * float(x))
            assert got[0].tolist() == [float(want)] * 3
            assert got[1].tolist() == [0.0] * 3
