"""The port's fused BN->ReLU->1x1-conv op against the JAX package's.

The same numpy u, scale, shift, w and residual (a numpy seed) go
through `paddle_tpu/ops/pallas_fused.py::bn_act_conv1x1` (its Pallas
kernels in interpret mode on the CPU, as
`test_pallas_kernels.py::TestFusedBnActConv` runs them) and through the
port's `ops/bn_act_conv1x1`: the plain forward, and the autograd
Function whose backward on a CPU tensor is the plain B2 and B3. f32
against f32 on the CPU: every output within 1e-5 of the JAX value,
relative to the output's largest entry (the summation orders differ).

Cases: act in {relu, ""} x residual in {none, given}; N = 100 (the JAX
test's shape, ragged against any tile), N = 1; shift > 0, where a
padded row would leak relu(shift) into the statistics; gradients of
u, scale, shift, w and residual under the JAX test's loss, which
weights y, ssum and ssq.

B1, B2 and B3 run on the tensor cores at f32 accuracy (3xTF32: each
operand split into hi = tf32(x) and lo = tf32(x - hi), the product
hi*hi' + hi*lo' + lo*hi'). `test_three_tf32_*` emulates that split in
numpy (round to nearest, ties away, as `cvt.rna.tf32` does) and holds it
within 1e-5 of an f64 product at the kernels' depths, where one TF32
pass is not.

`TestOnCard` (marked `cuda`) holds the three Hopper kernels against
their plain versions on the card at the nine ResNet-50 site shapes
(batch 2) and ragged ones, shows B1, B2 and B3 bit-identical on a
repeat, and that one autograd step launches each once; and their bf16
forms against the bf16 plain versions at the same shapes where the
widths are multiples of 8 and at the edges of the bf16 B2/B3's tiles and
stages (rows 1, 127, 129, 255, 257; widths 8, 72, 136, 200, 2048; a B3
row split whose chunk boundary falls inside a stage), and the bf16 B2
and B3 bit-identical on a repeat (`tests/test_torch_amp.py` holds the
bf16 plain versions against the JAX op). It skips here; on a
machine with an H100 and no JAX: `python -m pytest --noconftest -m
cuda tests/test_torch_fused.py`.
"""

import numpy as np
import pytest
import torch

try:  # the CPU parity tests need JAX; the on-card tests do not
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas_fused import bn_act_conv1x1 as jfused
except ImportError:
    jax = None

from paddle_tpu_torch.ops import bn_act_conv1x1 as op

TOL = 1e-5

# name: (N, Cin, Cout, act, with_res, positive_shift)
CASES = {
    "relu_n100": (100, 24, 16, "relu", False, False),
    "relu_res_n100": (100, 24, 16, "relu", True, False),
    "linear_n100": (100, 24, 16, "", False, False),
    "linear_res_n100": (100, 24, 16, "", True, False),
    "relu_n1": (1, 24, 16, "relu", False, False),
    "linear_res_n1": (1, 24, 16, "", True, False),
    "relu_positive_shift_n100": (100, 24, 16, "relu", False, True),
    "relu_res_odd_widths": (37, 19, 33, "relu", True, False),
}


def _inputs(n, cin, cout, positive_shift=False, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, cin)).astype(np.float32)
    sc = rng.standard_normal(cin).astype(np.float32)
    sh = rng.standard_normal(cin).astype(np.float32)
    if positive_shift:
        sh = np.abs(sh) + 1.0
    w = (rng.standard_normal((cin, cout)) * 0.1).astype(np.float32)
    r = rng.standard_normal((n, cin)).astype(np.float32)
    return u, sc, sh, w, r


def _close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= TOL, f"{name}: {err:.3g} relative to max > {TOL}"


def _loss_weights(y, s1, s2):
    # test_pallas_kernels.py::TestFusedBnActConv.test_grad_parity's loss
    return (y * 0.3).sum() + (s1 * 0.1).sum() + (s2 * 0.01).sum()


needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (CPU parity)")


@needs_jax
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    n, cin, cout, act, with_res, pos = CASES[name]
    u, sc, sh, w, r = _inputs(n, cin, cout, pos)
    res = r if with_res else None
    jy, js1, js2 = jfused(*(jnp.asarray(x) for x in (u, sc, sh, w)),
                          residual=None if res is None else jnp.asarray(res),
                          act=act)
    t = [torch.from_numpy(x) for x in (u, sc, sh, w)]
    tres = None if res is None else torch.from_numpy(res)
    before = op.fwd_launches
    for fn in (op.bn_act_conv1x1_plain, op.bn_act_conv1x1):
        y, s1, s2 = fn(*t, residual=tres, act=act)
        _close(y.detach(), jy, f"{name} y")
        _close(s1.detach(), js1, f"{name} ssum")
        _close(s2.detach(), js2, f"{name} ssq")
    assert op.fwd_launches == before    # the CPU path launches no kernel


@needs_jax
@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    n, cin, cout, act, with_res, pos = CASES[name]
    u, sc, sh, w, r = _inputs(n, cin, cout, pos, seed=1)
    args = [u, sc, sh, w] + ([r] if with_res else [])

    def jloss(u, sc, sh, w, *rest):
        y, s1, s2 = jfused(u, sc, sh, w, residual=rest[0] if rest else None,
                           act=act)
        return _loss_weights(y, s1, s2)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(x) for x in args))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    before = (op.bwd_dx_launches, op.bwd_dw_launches)
    y, s1, s2 = op.bn_act_conv1x1(*leaves[:4], residual=(
        leaves[4] if with_res else None), act=act)
    _loss_weights(y, s1, s2).backward()
    for nm, leaf, g in zip(("u", "scale", "shift", "w", "residual"),
                           leaves, jgrads):
        _close(leaf.grad, g, f"{name} d{nm}")
    assert (op.bwd_dx_launches, op.bwd_dw_launches) == before


@pytest.mark.parametrize("with_res", [False, True])
def test_plain_backward_is_autograd_of_plain_forward(with_res):
    """bn_act_conv1x1_bwd_{dx,dw}_plain equal autograd through
    bn_act_conv1x1_plain, with non-zero cotangents of y, ssum and ssq."""
    u, sc, sh, w, r = _inputs(50, 12, 20, seed=2)
    rng = np.random.default_rng(3)
    dy = torch.from_numpy(rng.standard_normal((50, 20)).astype(np.float32))
    d1 = torch.from_numpy(rng.standard_normal(20).astype(np.float32))
    d2 = torch.from_numpy(rng.standard_normal(20).astype(np.float32))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (u, sc, sh, w, r)]
    res = leaves[4] if with_res else None
    y, s1, s2 = op.bn_act_conv1x1_plain(*leaves[:4], residual=res)
    ((y * dy).sum() + (s1 * d1).sum() + (s2 * d2).sum()).backward()
    t = [x.detach() for x in leaves]
    tres = t[4] if with_res else None
    du, dsc, dsh, dres = op.bn_act_conv1x1_bwd_dx_plain(
        *t[:4], tres, y.detach(), dy, d1, d2)
    dw = op.bn_act_conv1x1_bwd_dw_plain(*t[:3], tres, y.detach(), dy, d1, d2)
    for nm, got, leaf in (("u", du, leaves[0]), ("scale", dsc, leaves[1]),
                          ("shift", dsh, leaves[2]), ("w", dw, leaves[3])):
        _close(got, leaf.grad, nm)
    if with_res:
        _close(dres, leaves[4].grad, "residual")
    else:
        assert dres is None and leaves[4].grad is None


def test_unused_statistics_take_zero_cotangents():
    """Only y feeds the loss: ssum and ssq's cotangents arrive as zeros
    and the gradient is that of y alone."""
    u, sc, sh, w, _r = (torch.from_numpy(x) for x in _inputs(30, 8, 6))
    w1 = w.clone().requires_grad_(True)
    y, _s1, _s2 = op.bn_act_conv1x1(u, sc, sh, w1)
    y.sum().backward()
    w2 = w.clone().requires_grad_(True)
    op.bn_act_conv1x1_plain(u, sc, sh, w2)[0].sum().backward()
    torch.testing.assert_close(w1.grad, w2.grad)


def _tf32(x):
    """x (f32) rounded to TF32 as `cvt.rna.tf32.f32` rounds: 10 mantissa
    bits, to nearest, ties away from zero (finite x)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _three_tf32(a, b):
    """a @ b as B2 and B3 form it: hi/lo splits of both operands, the
    three products accumulated in f32, small terms first."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)

    def mm(x, y):
        return (torch.from_numpy(x) @ torch.from_numpy(y)).numpy()

    acc = mm(a_lo, b_hi)
    acc = acc + mm(a_hi, b_lo)
    return acc + mm(a_hi, b_hi)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)         # a TF32 ulp at 1
    x = np.asarray([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.999,
                    one + 3 * ulp / 2], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.asarray([one + ulp, -(one + ulp), one, one + 2 * ulp],
                             np.float32))
    # hi + lo keeps 21 of f32's 24 bits: |hi + lo - x| <= 2^-21 |x|
    v = np.random.default_rng(5).standard_normal(1000).astype(np.float32)
    hi = _tf32(v)
    assert (np.abs(hi + _tf32(v - hi) - v) <= 2.0 ** -21 * np.abs(v)).all()


@pytest.mark.parametrize("k", [256, 2048, 12544])
def test_three_tf32_product_holds_f32_accuracy(k):
    """At K = 256 (a site's Cout, B2's depth), K = 2048 (B1's deepest Cin,
    res5bc_a) and K = 12 544 (the res4 rows of a batch of 64, B3's depth)
    the 3xTF32 product of z (ReLU'd)
    and dy_eff stays within 1e-5 of the f64 product, relative to its
    largest entry; one TF32 pass does not."""
    rng = np.random.default_rng(k)
    a = np.maximum(rng.standard_normal((64, k)), 0).astype(np.float32)
    b = rng.standard_normal((k, 48)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    err3 = np.abs(_three_tf32(a, b) - ref).max() / scale
    err1 = np.abs(
        (torch.from_numpy(_tf32(a)) @ torch.from_numpy(_tf32(b))).numpy()
        - ref).max() / scale
    assert err3 <= 1e-5, err3
    assert err1 > 1e-5, err1


def test_wrappers_refuse_what_the_kernels_do_not_take():
    u, sc, sh, w, _r = (torch.from_numpy(x) for x in _inputs(10, 4, 4))
    with pytest.raises(ValueError, match="act must be"):
        op.bn_act_conv1x1(u, sc, sh, w, act="tanh")
    # the kernel wrappers take CUDA tensors only; the CPU path is the
    # custom op's CPU implementation, the plain versions
    with pytest.raises(ValueError, match="unsupported device"):
        op.bn_act_conv1x1_fwd(u, sc, sh, w)
    y = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        op.bn_act_conv1x1_bwd_dx(u, sc, sh, w, None, y, y, sc, sc)
    with pytest.raises(ValueError, match="unsupported device"):
        op.bn_act_conv1x1_bwd_dw(u, sc, sh, None, y, y, sc, sc)


# ---- on the card --------------------------------------------------------

# (N, Cin, Cout): ragged against the tiles (widths not a multiple of 4
# take the kernels' 4-byte copies), N = 1, and the nine ResNet-50 sites
# at batch 2 (res4_a_b2 is the res4b-f_a site)
CARD_SHAPES = {
    "n100_24_16": (100, 24, 16),
    "n1_24_16": (1, 24, 16),
    "n517_70_130": (517, 70, 130),
    "n300_200_72": (300, 200, 72),
    "res2a_a_b2": (6272, 64, 64),
    "res2bc_a_b2": (6272, 256, 64),
    "res3bcd_a_b2": (1568, 512, 128),
    "res4_a_b2": (392, 1024, 256),
    "res5bc_a_b2": (98, 2048, 512),
    "res2_tail_b2": (6272, 64, 256),
    "res3_tail_b2": (1568, 128, 512),
    "res4_tail_b2": (392, 256, 1024),
    "res5_tail_b2": (98, 512, 2048),
}


# the bf16 forms take widths that are multiples of 8: the sites and the
# ragged rows, then the edges of the wgmma kernels' 128 x 128 tiles (B1's
# 128 x 64 at Cout <= 64, 128 x 256 at Cout >= 256) and 64-row stages
# (rows 1, 127, 129, 255, 257; widths 8, 72, 136, 200, 2048, 264 past a
# 256-column tile, Cin 520 and 2056 with a partial last stage), a B3 row
# split into two chunks whose boundary falls inside a stage, and three of
# B1's persistent walks long enough that its ring and y buffers wrap, one
# a tile width (118 301 rows: 925 row tiles over 132 blocks; 20 001: 157
# over 66 blocks of 2 Cout tiles; 4001: 32 over 26 blocks of 5)
BF16_SHAPES = {k: v for k, v in CARD_SHAPES.items()
               if v[1] % 8 == 0 and v[2] % 8 == 0}
BF16_SHAPES["n517_72_136"] = (517, 72, 136)
BF16_EDGE_SHAPES = {
    "n1_8_8": (1, 8, 8),
    "n127_8_72": (127, 8, 72),
    "n129_72_8": (129, 72, 8),
    "n255_136_200": (255, 136, 200),
    "n257_200_136": (257, 200, 136),
    "n129_2048_72": (129, 2048, 72),
    "n257_72_2048": (257, 72, 2048),
    "n600_64_64_split2": (600, 64, 64),
    "n127_64_8": (127, 64, 8),
    "n129_520_64": (129, 520, 64),
    "n257_2056_264": (257, 2056, 264),
    "n4001_72_1032": (4001, 72, 1032),
    "n20001_72_200": (20001, 72, 200),
    "n118301_64_64": (118301, 64, 64),
}
BF16_SHAPES.update(BF16_EDGE_SHAPES)


@pytest.mark.cuda
class TestOnCard:
    """The kernels against their plain versions on the card: max |diff|
    / max |plain| <= 1e-4 for every output (f32, other summation
    orders)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernels have no CPU mode")

    @staticmethod
    def _rel(got, ref):
        return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
                ).item()

    @pytest.mark.parametrize("act", ["relu", ""])
    @pytest.mark.parametrize("with_res", [False, True])
    @pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
    def test_kernels_match_plain(self, shape, act, with_res):
        n, cin, cout = CARD_SHAPES[shape]
        u, sc, sh, w, r = (torch.from_numpy(x).cuda() for x in
                           _inputs(n, cin, cout, positive_shift=True))
        res = r if with_res else None
        g = torch.Generator(device="cuda").manual_seed(0)
        dy = torch.randn((n, cout), generator=g, device="cuda")
        d1 = torch.randn((cout,), generator=g, device="cuda")
        d2 = torch.randn((cout,), generator=g, device="cuda") * 0.01
        got = op.bn_act_conv1x1_fwd(u, sc, sh, w, res, act)
        ref = op.bn_act_conv1x1_plain(u, sc, sh, w, res, act)
        y = ref[0]
        got += op.bn_act_conv1x1_bwd_dx(u, sc, sh, w, res, y, dy, d1, d2,
                                        act)
        got += (op.bn_act_conv1x1_bwd_dw(u, sc, sh, res, y, dy, d1, d2, act),)
        ref += op.bn_act_conv1x1_bwd_dx_plain(u, sc, sh, w, res, y, dy, d1,
                                              d2, act)
        ref += (op.bn_act_conv1x1_bwd_dw_plain(u, sc, sh, res, y, dy, d1, d2,
                                               act),)
        torch.cuda.synchronize()
        names = ("y", "ssum", "ssq", "du", "dscale", "dshift", "dres", "dw")
        for nm, a, b in zip(names, got, ref):
            if b is None:
                assert a is None, nm
                continue
            assert torch.isfinite(a).all(), nm
            assert self._rel(a, b) <= 1e-4, (nm, self._rel(a, b))

    @pytest.mark.parametrize("with_res", [False, True])
    @pytest.mark.parametrize("shape", ["n517_70_130", "res2_tail_b2",
                                       "res5bc_a_b2", "res5_tail_b2"])
    def test_backward_kernels_are_bit_identical_on_a_repeat(self, shape,
                                                            with_res):
        """B1's and B2's column sums and B3's split-K partials are summed
        in a fixed order, without atomics: B1, B2 and B3 repeat bit for
        bit."""
        n, cin, cout = CARD_SHAPES[shape]
        u, sc, sh, w, r = (torch.from_numpy(x).cuda() for x in
                           _inputs(n, cin, cout, seed=4))
        res = r if with_res else None
        g = torch.Generator(device="cuda").manual_seed(1)
        y = op.bn_act_conv1x1_plain(u, sc, sh, w, res)[0]
        dy = torch.randn((n, cout), generator=g, device="cuda")
        d1 = torch.randn((cout,), generator=g, device="cuda")
        d2 = torch.randn((cout,), generator=g, device="cuda") * 0.01
        runs = [op.bn_act_conv1x1_fwd(u, sc, sh, w, res)
                + op.bn_act_conv1x1_bwd_dx(u, sc, sh, w, res, y, dy, d1, d2)
                + (op.bn_act_conv1x1_bwd_dw(u, sc, sh, res, y, dy, d1, d2),)
                for _ in range(2)]
        torch.cuda.synchronize()
        for nm, a, b in zip(("y", "ssum", "ssq", "du", "dscale", "dshift",
                             "dres", "dw"), *runs):
            assert (a is None and b is None) or torch.equal(a, b), nm

    @staticmethod
    def _bf16_off(got, ref):
        """Elements of bf16 `got` farther from `ref` than one bf16 ulp of
        the reference value plus 1e-4 of its largest entry."""
        got, ref = got.float(), ref.float()
        ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
        return int(((got - ref).abs() > ulp + 1e-4 * ref.abs().max()).sum())

    @pytest.mark.parametrize("act", ["relu", ""])
    @pytest.mark.parametrize("with_res", [False, True])
    @pytest.mark.parametrize("shape", sorted(BF16_SHAPES))
    def test_bf16_kernels_match_plain(self, shape, act, with_res):
        """The bf16 forms against the bf16 plain versions: the f32
        outputs (ssum, ssq, dscale, dshift, dw) within 1e-4 of the
        largest, the bf16 ones (y, du, dres) element by element within
        one bf16 ulp plus 1e-4 of the largest; bit-identical on a
        repeat."""
        n, cin, cout = BF16_SHAPES[shape]
        u, sc, sh, w, r = (torch.from_numpy(x).cuda() for x in
                           _inputs(n, cin, cout, positive_shift=True))
        u, w, r = (x.to(torch.bfloat16) for x in (u, w, r))
        res = r if with_res else None
        g = torch.Generator(device="cuda").manual_seed(0)
        dy = torch.randn((n, cout), generator=g, device="cuda").to(
            torch.bfloat16)
        d1 = torch.randn((cout,), generator=g, device="cuda")
        d2 = torch.randn((cout,), generator=g, device="cuda") * 0.01
        ref = op.bn_act_conv1x1_plain(u, sc, sh, w, res, act)
        y = ref[0]
        ref += op.bn_act_conv1x1_bwd_dx_plain(u, sc, sh, w, res, y, dy, d1,
                                              d2, act)
        ref += (op.bn_act_conv1x1_bwd_dw_plain(u, sc, sh, res, y, dy, d1, d2,
                                               act),)
        before = (op.fwd_launches, op.bwd_dx_launches, op.bwd_dw_launches)
        runs = [op.bn_act_conv1x1_fwd(u, sc, sh, w, res, act)
                + op.bn_act_conv1x1_bwd_dx(u, sc, sh, w, res, y, dy, d1, d2,
                                           act)
                + (op.bn_act_conv1x1_bwd_dw(u, sc, sh, res, y, dy, d1, d2,
                                            act),) for _ in range(2)]
        torch.cuda.synchronize()
        assert (op.fwd_launches, op.bwd_dx_launches,
                op.bwd_dw_launches) == before   # no f32 form launched
        names = ("y", "ssum", "ssq", "du", "dscale", "dshift", "dres", "dw")
        for nm, a, b, again in zip(names, runs[0], ref, runs[1]):
            if b is None:
                assert a is None, nm
                continue
            assert a.dtype == b.dtype and torch.isfinite(a).all(), nm
            assert torch.equal(a, again), nm
            if a.dtype == torch.bfloat16:
                assert self._bf16_off(a, b) == 0, (nm, self._bf16_off(a, b))
            else:
                assert self._rel(a, b) <= 1e-4, (nm, self._rel(a, b))

    @pytest.mark.parametrize("with_res", [False, True])
    @pytest.mark.parametrize("shape", ["n517_72_136", "n600_64_64_split2",
                                       "res2_tail_b2", "res5bc_a_b2",
                                       "res5_tail_b2"])
    def test_bf16_backward_kernels_are_bit_identical_on_a_repeat(
            self, shape, with_res):
        """The bf16 B2's column partials and B3's split-K partials are
        summed in a fixed order, without atomics: B2 and B3 repeat bit
        for bit."""
        n, cin, cout = BF16_SHAPES[shape]
        u, sc, sh, w, r = (torch.from_numpy(x).cuda() for x in
                           _inputs(n, cin, cout, seed=4))
        u, w, r = (x.to(torch.bfloat16) for x in (u, w, r))
        res = r if with_res else None
        g = torch.Generator(device="cuda").manual_seed(1)
        y = op.bn_act_conv1x1_plain(u, sc, sh, w, res)[0]
        dy = torch.randn((n, cout), generator=g, device="cuda").to(
            torch.bfloat16)
        d1 = torch.randn((cout,), generator=g, device="cuda")
        d2 = torch.randn((cout,), generator=g, device="cuda") * 0.01
        runs = [op.bn_act_conv1x1_bwd_dx(u, sc, sh, w, res, y, dy, d1, d2)
                + (op.bn_act_conv1x1_bwd_dw(u, sc, sh, res, y, dy, d1, d2),)
                for _ in range(2)]
        torch.cuda.synchronize()
        for nm, a, b in zip(("du", "dscale", "dshift", "dres", "dw"), *runs):
            assert (a is None and b is None) or torch.equal(a, b), nm

    @pytest.mark.parametrize("with_res", [False, True])
    @pytest.mark.parametrize("shape", ["n4001_72_1032", "n257_2056_264",
                                       "res2_tail_b2", "res5bc_a_b2"])
    def test_bf16_forward_kernel_is_bit_identical_on_a_repeat(
            self, shape, with_res):
        """The bf16 B1's column sums are reduced in a fixed order (a
        block's rows, then its warps, then the blocks in col_reduce),
        without atomics: y, ssum and ssq repeat bit for bit."""
        n, cin, cout = BF16_SHAPES[shape]
        u, sc, sh, w, r = (torch.from_numpy(x).cuda() for x in
                           _inputs(n, cin, cout, seed=5))
        u, w, r = (x.to(torch.bfloat16) for x in (u, w, r))
        res = r if with_res else None
        runs = [op.bn_act_conv1x1_fwd(u, sc, sh, w, res) for _ in range(2)]
        torch.cuda.synchronize()
        for nm, a, b in zip(("y", "ssum", "ssq"), *runs):
            assert torch.equal(a, b), nm

    @pytest.mark.parametrize("with_res", [False, True])
    @pytest.mark.parametrize("shape", sorted(BF16_SHAPES))
    def test_bf16_forward_plan_is_a_persistent_grid(self, shape, with_res):
        """The bf16 B1 walks row tiles in a persistent grid: at most one
        block an SM (132 on an H100 SXM), each asking for more than half
        an SM's shared memory so that no two share one; a 128-row tile 64
        columns wide at Cout <= 64, 256 at Cout >= 256, else 128."""
        n, cin, cout = BF16_SHAPES[shape]
        plan = op.launch_plan(n, cin, cout, residual=with_res,
                              dtype=torch.bfloat16)["fwd"]
        cols = 64 if cout <= 64 else 256 if cout >= 256 else 128
        assert plan["tile"] == [128, cols], plan
        col_tiles = -(-cout // cols)
        assert plan["blocks"] % col_tiles == 0, plan
        walkers = plan["blocks"] // col_tiles
        assert plan["blocks"] <= 132, plan
        assert walkers == min(max(132 // col_tiles, 1), -(-n // 128)), plan
        props = torch.cuda.get_device_properties(0)
        per_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
        assert 2 * plan["smem_bytes"] > per_sm, (plan, per_sm)

    def test_bf16_dw_split_boundary_falls_inside_a_stage(self):
        """n600_64_64_split2 splits B3's rows into two chunks whose
        boundary is not a multiple of the 64-row stage: the first chunk's
        last stage holds the second chunk's rows, which its row mask must
        drop (test_bf16_kernels_match_plain holds the result)."""
        n, cin, cout = BF16_SHAPES["n600_64_64_split2"]
        plan = op.launch_plan(n, cin, cout, dtype=torch.bfloat16)["bwd_dw"]
        assert plan["blocks"] == 2 and plan["chunk"] % 64 != 0, plan
        assert plan["chunk"] < n, plan

    def test_autograd_step_launches_each_kernel_once(self):
        u, sc, sh, w, r = (torch.from_numpy(x).cuda().requires_grad_(True)
                           for x in _inputs(300, 64, 96))
        before = (op.fwd_launches, op.bwd_dx_launches, op.bwd_dw_launches)
        y, s1, s2 = op.bn_act_conv1x1(u, sc, sh, w, residual=r)
        _loss_weights(y, s1, s2).backward()
        torch.cuda.synchronize()
        assert (op.fwd_launches, op.bwd_dx_launches, op.bwd_dw_launches) == (
            before[0] + 1, before[1] + 1, before[2] + 1)
        leaves = [x.detach().requires_grad_(True) for x in (u, sc, sh, w, r)]
        yp, s1p, s2p = op.bn_act_conv1x1_plain(*leaves[:4],
                                               residual=leaves[4])
        _loss_weights(yp, s1p, s2p).backward()
        for a, b in zip((u, sc, sh, w, r), leaves):
            assert self._rel(a.grad, b.grad) <= 1e-4
