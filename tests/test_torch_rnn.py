"""The port's LSTM/GRU sequence ops (`paddle_tpu_torch/ops/rnn.py`) and
sequence ops against the JAX package's, on the CPU.

The same numpy inputs (a numpy seed; B = 5, T = 13, h = 32, lengths
[13, 0, 1, 7, 12]) go through `paddle_tpu/ops/pallas_rnn.py` — its scan
references `lstm_ref`/`gru_ref` and its Pallas kernels in interpret
mode, as `test_pallas_kernels.py` runs them, once with the default VMEM
budget (one time block) and once with the budget patched down so that
the kernels walk two time blocks and carry h/c across the boundary —
and through the port's plain versions and custom ops:

- forward: `lstm_plain` (y and the cell sequence c) and `gru_plain`
  within 1e-5 (atol) of both JAX versions;
- backward: `lstm_bwd_plain`/`gru_bwd_plain` and autograd through
  `lstm_seq`/`gru_seq` (the ops) within 2e-4 (atol) of `jax.vjp` of the
  interpret-mode kernels;
- every function of `ops/sequence_ops.py` against the JAX original
  (exact up to f32 summation order, 1e-6);
- the GRU's plain versions past the cluster routes' widths (h = 336,
  where B8 alone takes the grid route on the card, and h = 1000, the
  RNNsearch encoder's), ragged with a 0 length, against `gru_ref` and
  the interpret-mode `gru_fused` and its `jax.vjp`.

`TestOnCard` (marked `cuda`) holds the four Hopper kernels against
their plain versions on the card — each on the route its rule picks
and, where that is the cluster route, on the grid route too, the
cluster and grid routes bit-identical on a repeat — pins the width at
which each kernel's cluster route gives way to the grid route, checks
the grid route's plans (one block an SM at most, the weights streamed
and the rows chunked where a block's shared memory does not hold
them), and shows that one autograd step launches each kernel once. It
skips here; on a machine with an H100 and no JAX: `python -m pytest
--noconftest -m cuda tests/test_torch_rnn.py`.
"""

import numpy as np
import pytest
import torch

try:  # the CPU parity tests need JAX; the on-card tests do not
    import jax
    import jax.numpy as jnp

    import paddle_tpu.ops.pallas_rnn as pr
    from paddle_tpu.ops import sequence_ops as jsops
except ImportError:
    jax = None

from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.ops import sequence_ops as tsops

B, T, H = 5, 13, 32
LENS = np.asarray([13, 0, 1, 7, 12], np.int32)
# the patched budgets put the JAX kernels' T = 13 in two time blocks of 8
# (forward and backward, LSTM and GRU; checked by test_small_budget_...)
SMALL_BUDGET, SMALL_BUDGET_BWD = 120_000, 300_000

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (CPU parity)")


def _lstm_inputs(seed=0, b=B, t=T, h=H, w_scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    w = (rng.standard_normal((h, 4 * h)) * w_scale).astype(np.float32)
    gb = (rng.standard_normal(4 * h) * 0.1).astype(np.float32)
    peep = [(rng.standard_normal(h) * 0.1).astype(np.float32)
            for _ in range(3)]
    dy = rng.standard_normal((b, t, h)).astype(np.float32)
    return [x, w, gb, *peep], dy


def _gru_inputs(seed=1, b=B, t=T, h=H, w_scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 3 * h)).astype(np.float32)
    w_g = (rng.standard_normal((h, 2 * h)) * w_scale).astype(np.float32)
    w_c = (rng.standard_normal((h, h)) * w_scale).astype(np.float32)
    bias = (rng.standard_normal(3 * h) * 0.1).astype(np.float32)
    dy = rng.standard_normal((b, t, h)).astype(np.float32)
    return [x, w_g, w_c, bias], dy


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _b7(args):
    return torch.cat(_t(args[2:6]))


@pytest.fixture(params=["default_budget", "small_budget"])
def budget(request, monkeypatch):
    if request.param == "small_budget":
        monkeypatch.setattr(pr, "_VMEM_BUDGET", SMALL_BUDGET)
        monkeypatch.setattr(pr, "_VMEM_BUDGET_BWD", SMALL_BUDGET_BWD)
    return request.param


@needs_jax
def test_small_budget_splits_time_into_two_blocks(monkeypatch):
    monkeypatch.setattr(pr, "_VMEM_BUDGET", SMALL_BUDGET)
    monkeypatch.setattr(pr, "_VMEM_BUDGET_BWD", SMALL_BUDGET_BWD)
    for plan in (pr._lstm_plan, pr._lstm_bwd_plan, pr._gru_plan,
                 pr._gru_bwd_plan):
        _bb, tb, _bp, tp = plan(B, T, H)
        assert tp // tb == 2, plan.__name__


@needs_jax
def test_lstm_forward_matches_jax(budget):
    args, _ = _lstm_inputs()
    ja = [jnp.asarray(a) for a in args]
    jl = jnp.asarray(LENS)
    ref = np.asarray(pr.lstm_ref(*ja, jl))
    kern = np.asarray(pr.lstm_fused(*ja, jl, True))
    b7 = jnp.concatenate(ja[2:6])[None, :]
    _y, jc = pr._lstm_fwd_pallas(ja[0], ja[1], b7, jl[:, None],
                                 interpret=True, want_c=True)
    y, c = rnn.lstm_plain(*_t(args), torch.from_numpy(LENS), want_c=True)
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), kern, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(y.numpy()[1], 0.0)     # len 0


@needs_jax
def test_gru_forward_matches_jax(budget):
    args, _ = _gru_inputs()
    ja = [jnp.asarray(a) for a in args]
    jl = jnp.asarray(LENS)
    y = rnn.gru_plain(*_t(args), torch.from_numpy(LENS)).numpy()
    np.testing.assert_allclose(y, np.asarray(pr.gru_ref(*ja, jl)), atol=1e-5)
    np.testing.assert_allclose(y, np.asarray(pr.gru_fused(*ja, jl, True)),
                               atol=1e-5)
    np.testing.assert_array_equal(y[1], 0.0)


@needs_jax
def test_lstm_backward_matches_jax(budget):
    args, dy = _lstm_inputs(seed=2)
    jl = jnp.asarray(LENS)
    _y, vjp = jax.vjp(lambda *a: pr.lstm_fused(*a, jl, True),
                      *(jnp.asarray(a) for a in args))
    jx, jw, jgb, jci, jcf, jco = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    jb7 = np.concatenate([jgb, jci, jcf, jco])
    x, w = _t(args[:2])
    b7, lens, tdy = _b7(args), torch.from_numpy(LENS), torch.from_numpy(dy)
    y, c = rnn.lstm_plain(x, w, *_t(args[2:6]), lens, want_c=True)
    for name, got in zip(("dx", "dw", "db7"),
                         rnn.lstm_bwd_plain(x, w, b7, lens, y, c, tdy)):
        np.testing.assert_allclose(got.numpy(), {"dx": jx, "dw": jw,
                                                 "db7": jb7}[name],
                                   atol=2e-4, err_msg=name)
    leaves = [v.clone().requires_grad_(True) for v in (x, w, b7)]
    before = (rnn.lstm_fwd_launches, rnn.lstm_bwd_launches)
    rnn.lstm_seq(*leaves, lens).backward(tdy)
    assert (rnn.lstm_fwd_launches, rnn.lstm_bwd_launches) == before
    for leaf, want in zip(leaves, (jx, jw, jb7)):
        np.testing.assert_allclose(leaf.grad.numpy(), want, atol=2e-4)


@needs_jax
def test_gru_backward_matches_jax(budget):
    args, dy = _gru_inputs(seed=3)
    jl = jnp.asarray(LENS)
    _y, vjp = jax.vjp(lambda *a: pr.gru_fused(*a, jl, True),
                      *(jnp.asarray(a) for a in args))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    targs = _t(args)
    lens, tdy = torch.from_numpy(LENS), torch.from_numpy(dy)
    y = rnn.gru_plain(*targs, lens)
    for name, got, w in zip(("dx", "dw_g", "dw_c", "db"),
                            rnn.gru_bwd_plain(*targs, lens, y, tdy), want):
        np.testing.assert_allclose(got.numpy(), w, atol=2e-4, err_msg=name)
    leaves = [v.clone().requires_grad_(True) for v in targs]
    before = (rnn.gru_fwd_launches, rnn.gru_bwd_launches)
    rnn.gru_seq(*leaves, lens).backward(tdy)
    assert (rnn.gru_fwd_launches, rnn.gru_bwd_launches) == before
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=2e-4)


def test_entry_points_take_the_plain_versions_on_the_cpu():
    """lstm_fused without gradients is the plain forward; with them the
    op's autograd formula, whose gradient is autograd's through the plain
    forward. gru_fused likewise. No kernel is counted."""
    args, dy = _lstm_inputs(seed=4, h=8)
    lens = torch.from_numpy(LENS)
    counters = ("lstm_fwd_launches", "lstm_fwd_infer_launches",
                "lstm_bwd_launches", "gru_fwd_launches", "gru_bwd_launches")
    before = [getattr(rnn, c) for c in counters]
    with torch.no_grad():
        y = rnn.lstm_fused(*_t(args), lens)
    torch.testing.assert_close(y, rnn.lstm_plain(*_t(args), lens))
    leaves = [a.requires_grad_(True) for a in _t(args)]
    rnn.lstm_fused(*leaves, lens).backward(torch.from_numpy(dy))
    ref = [a.requires_grad_(True) for a in _t(args)]
    rnn.lstm_plain(*ref, lens).backward(torch.from_numpy(dy))
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)
    gargs, gdy = _gru_inputs(seed=5, h=8)
    leaves = [a.requires_grad_(True) for a in _t(gargs)]
    rnn.gru_fused(*leaves, lens).backward(torch.from_numpy(gdy))
    ref = [a.requires_grad_(True) for a in _t(gargs)]
    rnn.gru_plain(*ref, lens).backward(torch.from_numpy(gdy))
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)
    assert [getattr(rnn, c) for c in counters] == before


def _kernel_calls(route):
    """Every kernel wrapper on CPU tensors (h = 4) with `route`."""
    args, dy = _lstm_inputs(h=4)
    x, w = _t(args[:2])
    lens = torch.from_numpy(LENS)
    b7, y = _b7(args), torch.from_numpy(dy)
    gargs, gdy = _gru_inputs(h=4)
    g, gy = _t(gargs), torch.from_numpy(gdy)
    return [lambda: rnn.lstm_seq_fwd(x, w, b7, lens, route=route),
            lambda: rnn.lstm_seq_fwd(x, w, b7, lens, want_c=False,
                                     route=route),
            lambda: rnn.lstm_seq_bwd(x, w, b7, lens, y, y, y, route=route),
            lambda: rnn.gru_seq_fwd(*g, lens, route=route),
            lambda: rnn.gru_seq_bwd(*g, lens, gy, gy, route=route)]


def test_kernel_wrappers_refuse_the_cpu():
    for route in (None, "cluster", "grid"):
        for call in _kernel_calls(route):
            with pytest.raises(ValueError, match="unsupported device"):
                call()


@pytest.mark.parametrize("route", ["fast", "Cluster", 0, "Grid", "walk"])
def test_unknown_route_is_refused_before_any_build(route, monkeypatch):
    """A route name that is not one of rnn.ROUTES raises ValueError, on
    any kernel's wrapper and plan, before a kernel is built or a device
    is asked."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(rnn._build, "load", no_build)
    cuda = torch.device("cuda")
    calls = _kernel_calls(route) + [
        lambda: rnn.fwd_plan(kernel, 5, 32, cuda, route=route)
        for kernel in (rnn.LSTM_KERNEL, rnn.GRU_KERNEL)] + [
        lambda: rnn.bwd_plan(kernel, 5, 32, cuda, route=route)
        for kernel in (rnn.LSTM_KERNEL, rnn.GRU_KERNEL)]
    for call in calls:
        with pytest.raises(ValueError, match="route must be"):
            call()


# (B, T, h, lens) of the GRU past the cluster routes' widths: h = 336 (B7
# on the cluster route, B8 on the grid route on the card) and the RNNsearch
# encoder's h = 1000, ragged with a 0 length; the recurrent weights at the
# layers' init scale 1/sqrt(h)
WIDE_GRU = {"h336": (4, 5, 336, [5, 0, 2, 4]),
            "h1000": (3, 4, 1000, [4, 1, 0])}


@needs_jax
@pytest.mark.parametrize("case", sorted(WIDE_GRU))
def test_gru_matches_jax_past_the_cluster_widths(case):
    """gru_plain within 1e-5 of `gru_ref` and the interpret-mode
    `gru_fused`; gru_bwd_plain and autograd through gru_seq within 2e-4
    of `jax.vjp` of `gru_fused`, exactly 0 past each row's length."""
    b, t, h, lens = WIDE_GRU[case]
    args, dy = _gru_inputs(seed=11, b=b, t=t, h=h, w_scale=h ** -0.5)
    ja = [jnp.asarray(a) for a in args]
    jl = jnp.asarray(np.asarray(lens, np.int32))
    tl = torch.tensor(lens, dtype=torch.int32)
    targs = _t(args)
    y = rnn.gru_plain(*targs, tl)
    jy, vjp = jax.vjp(lambda *a: pr.gru_fused(*a, jl, True), *ja)
    np.testing.assert_allclose(y.numpy(), np.asarray(pr.gru_ref(*ja, jl)),
                               atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    dead = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    np.testing.assert_array_equal(y.numpy()[dead], 0.0)
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    tdy = torch.from_numpy(dy)
    got = rnn.gru_bwd_plain(*targs, tl, y, tdy)
    for name, g, w in zip(("dx", "dw_g", "dw_c", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, err_msg=name)
    np.testing.assert_array_equal(got[0].numpy()[dead], 0.0)
    leaves = [v.clone().requires_grad_(True) for v in targs]
    rnn.gru_seq(*leaves, tl).backward(tdy)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=2e-4)


# ---- sequence ops ---------------------------------------------------------

def _seq_case(name):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, 6)).astype(np.float32)
    v = rng.standard_normal((B, 6)).astype(np.float32)
    sub = np.asarray([[5, 7, 0], [0, 0, 0], [1, 0, 0], [3, 3, 1],
                      [2, 4, 6]], np.int32)
    lens2 = np.asarray([2, 4, 0, 9, 1], np.int32)
    cases = {
        "seq_sum": ("seq_sum", (x, LENS)),
        "seq_avg": ("seq_avg", (x, LENS)),
        "seq_sqrt_avg": ("seq_sqrt_avg", (x, LENS)),
        "seq_max": ("seq_max", (x, LENS)),
        "seq_last": ("seq_last", (x, LENS)),
        "seq_first": ("seq_first", (x, LENS)),
        "expand_to_seq": ("expand_to_seq", (v, LENS, T)),
        "masked_softmax": ("masked_softmax", (x[..., 0], LENS)),
        "reverse_seq": ("reverse_seq", (x, LENS)),
        "seq_concat": ("seq_concat", (x, LENS, x[:, :9] * 2, lens2)),
        "seq_shift_fwd": ("seq_shift", (x, LENS, 2)),
        "seq_shift_back": ("seq_shift", (x, LENS, -3)),
        "seq_slice_window": ("seq_slice_window", (x, LENS, 3, 6)),
        "subseq_to_seq_lens": ("subseq_to_seq_lens", (sub,)),
    }
    for op in ("sum", "avg", "sqrt_avg", "max", "last", "first"):
        cases[f"subseq_pool_{op}"] = ("subseq_pool", (x, sub, op))
    return cases[name]


SEQ_CASES = ["seq_sum", "seq_avg", "seq_sqrt_avg", "seq_max", "seq_last",
             "seq_first", "expand_to_seq", "masked_softmax", "reverse_seq",
             "seq_concat", "seq_shift_fwd", "seq_shift_back",
             "seq_slice_window", "subseq_to_seq_lens"] + [
    f"subseq_pool_{op}" for op in ("sum", "avg", "sqrt_avg", "max", "last",
                                   "first")]


@needs_jax
@pytest.mark.parametrize("name", SEQ_CASES)
def test_sequence_op_matches_jax(name):
    fn, args = _seq_case(name)
    jout = getattr(jsops, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                else a for a in args))
    tout = getattr(tsops, fn)(*(torch.from_numpy(a)
                                if isinstance(a, np.ndarray) else a
                                for a in args))
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


# ---- on the card --------------------------------------------------------

# (B, T, h, lens): the chip smoke's path shapes cut in T, the bench's
# other widths, and a ragged case with a zero length and a length of 1.
# The recurrent weights have the layers' init scale 1/sqrt(h): at a fixed
# 0.3 the recurrence of a wide GRU amplifies f32 rounding step by step
# (both the kernel's and the plain version's) past the tolerance.
CARD_CASES = {
    "b64_t12_h256": (64, 12, 256, None),
    "b20_t9_h512": (20, 9, 512, None),
    "b9_t5_h1280": (9, 5, 1280, None),
    "ragged_b5_t13_h32": (5, 13, 32, LENS),
    "ragged_b11_t7_h100": (11, 7, 100, [7, 0, 1, 3, 7, 2, 6, 5, 4, 1, 7]),
    # the path shapes: the classifier's layers, the NMT encoder
    "b64_t100_h256": (64, 100, 256, None),
    "b256_t32_h256": (256, 32, 256, None),
    # B = 37 is no multiple of the rows a cluster takes
    "ragged_b37_t9_h256": (37, 9, 256, [9, 0, 1] + [(5 * i) % 9 + 1
                                                      for i in range(34)]),
    # either side of the cluster routes' widest h (320; B7's 352)
    "b6_t7_h320": (6, 7, 320, None),
    "ragged_b6_t7_h328": (6, 7, 328, [7, 1, 0, 7, 3, 5]),
    "b5_t6_h352": (5, 6, 352, None),
    "ragged_b5_t6_h360": (5, 6, 360, [6, 0, 1, 6, 4]),
    # more clusters than the card holds at once: the cluster routes run
    # in two waves (WAVE_CASE)
    "b512_t6_h256": (512, 6, 256, None),
    # the LSTM's grid route at the bench's widest width and full length,
    # ragged at a rows count no multiple of 16, and wider than a block's
    # shared memory holds its slice of w (STREAMED_CASE: w read from L2),
    # and more rows than even the streamed forward's block holds
    # (CHUNKED_CASE: B5 in launches of fewer rows)
    "b64_t100_h1280": (64, 100, 1280, None),
    "ragged_b37_t9_h512": (37, 9, 512, [9, 0, 1] + [(4 * i) % 9 + 1
                                                      for i in range(34)]),
    "b3_t4_h2048": (3, 4, 2048, None),
    "ragged_b1200_t3_h1280": (1200, 3, 1280,
                              [3, 0, 1] + [i % 3 + 1 for i in range(1197)]),
    # the GRU's grid route at the NMT encoder's widths (bench_nmt's B and
    # T at hidden 1024 and 2560, the RNNsearch encoder's h = 1000), and
    # h = 336, where B7 takes the cluster route and B8 the grid route
    "b256_t32_h1000": (256, 32, 1000, None),
    "b256_t32_h1280": (256, 32, 1280, None),
    "ragged_b6_t7_h336": (6, 7, 336, [7, 0, 1, 7, 3, 5]),
    # past h = 2112 a block's forward gate columns outgrow one product job
    # (the GRU's 4 n-tiles, the LSTM's 8): several jobs a block, streamed
    "ragged_b3_t4_h2560": (3, 4, 2560, [4, 0, 2]),
}
WAVE_CASE = "b512_t6_h256"
STREAMED_CASE = "b3_t4_h2048"
CHUNKED_CASE = "ragged_b1200_t3_h1280"
# the widest h each kernel takes on the cluster route: its slices of the
# weights and buffers at one batch row a cluster fill a block's 227 KB
# (csrc lstm_seq.cu / gru_seq.cu: FwdSmem, WalkSmem); wider h takes the
# grid route
CLUSTER_MAX_H = {"lstm": 320, "gru": 320}          # B6, B8
FWD_CLUSTER_MAX_H = {"lstm": 320, "gru": 352}      # B5, B7
# each cell's route past the cluster route's widest h, and a route name it
# does not have (refused as an unknown route)
WIDE_ROUTE = {"lstm": "grid", "gru": "grid"}
NO_ROUTE = {"lstm": "walk", "gru": "walk"}
# the launch counters of each kernel: (either route, the cluster route,
# the grid route)
COUNTERS = {
    ("fwd", "lstm"): ("lstm_fwd_launches", "lstm_fwd_cluster_launches",
                      "lstm_fwd_grid_launches"),
    ("fwd_infer", "lstm"): ("lstm_fwd_infer_launches",
                            "lstm_fwd_infer_cluster_launches",
                            "lstm_fwd_infer_grid_launches"),
    ("bwd", "lstm"): ("lstm_bwd_launches", "lstm_bwd_cluster_launches",
                      "lstm_bwd_grid_launches"),
    ("fwd", "gru"): ("gru_fwd_launches", "gru_fwd_cluster_launches",
                     "gru_fwd_grid_launches"),
    ("bwd", "gru"): ("gru_bwd_launches", "gru_bwd_cluster_launches",
                     "gru_bwd_grid_launches"),
}


def _counts(counters):
    return [getattr(rnn, c) for c in counters]


@pytest.mark.cuda
class TestOnCard:
    """The kernels against their plain versions on the card: max |diff|
    / max |plain| <= 1e-4 for every output (f32, other summation
    orders), and exactly 0 past each row's length."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernels have no CPU mode")

    @staticmethod
    def _rel(got, ref):
        return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
                ).item()

    @staticmethod
    def _lens(b, t, lens):
        lens = np.full(b, t, np.int32) if lens is None else np.asarray(
            lens, np.int32)
        return torch.from_numpy(lens).cuda()

    @pytest.mark.parametrize("case", sorted(CARD_CASES))
    def test_lstm_kernels_match_plain(self, case):
        b, t, h, lens = CARD_CASES[case]
        args, dy = _lstm_inputs(b=b, t=t, h=h, w_scale=h ** -0.5)
        x, w, gb, ci, cf, co = (a.cuda() for a in _t(args))
        b7, dy, lens = torch.cat([gb, ci, cf, co]), torch.from_numpy(
            dy).cuda(), self._lens(b, t, lens)
        yp, cp = rnn.lstm_plain(x, w, gb, ci, cf, co, lens, want_c=True)
        dead = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        y, _c = self._hold("fwd", "lstm", h, dead, ("y", "c"), (yp, cp),
                           lambda route: rnn.lstm_seq_fwd(
                               x, w, b7, lens, want_c=True, route=route))

        def infer(route):
            out = rnn.lstm_seq_fwd(x, w, b7, lens, want_c=False, route=route)
            assert out[1] is None, "the inference variant returned a c"
            return out[:1]

        y_noc, = self._hold("fwd_infer", "lstm", h, dead, ("y",), (yp,),
                            infer)
        assert torch.equal(y, y_noc)
        ref = rnn.lstm_bwd_plain(x, w, b7, lens, yp, cp, dy)
        self._hold("bwd", "lstm", h, dead, ("dx", "dw", "db7"), ref,
                   lambda route: rnn.lstm_seq_bwd(x, w, b7, lens, yp, cp, dy,
                                                  route=route))

    @pytest.mark.parametrize("case", sorted(CARD_CASES))
    def test_gru_kernels_match_plain(self, case):
        b, t, h, lens = CARD_CASES[case]
        args, dy = _gru_inputs(b=b, t=t, h=h, w_scale=h ** -0.5)
        x, w_g, w_c, bias = (a.cuda() for a in _t(args))
        dy, lens = torch.from_numpy(dy).cuda(), self._lens(b, t, lens)
        yp = rnn.gru_plain(x, w_g, w_c, bias, lens)
        dead = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        self._hold("fwd", "gru", h, dead, ("y",), (yp,),
                   lambda route: (rnn.gru_seq_fwd(x, w_g, w_c, bias, lens,
                                                  route=route),))
        ref = rnn.gru_bwd_plain(x, w_g, w_c, bias, lens, yp, dy)
        self._hold("bwd", "gru", h, dead, ("dx", "dw_g", "dw_c", "db"), ref,
                   lambda route: rnn.gru_seq_bwd(x, w_g, w_c, bias, lens,
                                                 yp, dy, route=route))

    def _hold(self, kind, cell, h, dead, names, ref, call):
        """A kernel (`call(route)`, its outputs `names`; `kind` "fwd",
        "fwd_infer" or "bwd") against the plain version `ref` on the route
        the rule picks, which must be the cluster route exactly where h <=
        its FWD_CLUSTER_MAX_H / CLUSTER_MAX_H and else WIDE_ROUTE, and on
        WIDE_ROUTE where the rule picks the cluster route: every output
        within 1e-4, the first (y or dx) exactly 0 past len; both routes
        bit-identical on a repeat, launches counted by route; where h is
        too wide for it, the cluster route refused with nothing counted,
        and NO_ROUTE refused as an unknown route at every h, with nothing
        counted. Returns the rule's outputs."""
        counts = COUNTERS[kind, cell]
        kernel = rnn.LSTM_KERNEL if cell == "lstm" else rnn.GRU_KERNEL
        b = ref[0].shape[0]
        if kind == "bwd":
            plan, limit = rnn.bwd_plan, CLUSTER_MAX_H[cell]
        else:
            plan, limit = rnn.fwd_plan, FWD_CLUSTER_MAX_H[cell]
        plan = plan(kernel, b, h, ref[0].device)
        cluster = h <= limit
        wide = WIDE_ROUTE[cell]
        assert plan["route"] == ("cluster" if cluster else wide), plan
        before = _counts(counts)
        got = call(None)
        grid = plan["route"] == "grid"
        assert _counts(counts) == [before[0] + 1, before[1] + cluster,
                                   before[2] + grid]
        runs = [(plan["route"], got)]
        if cluster:
            runs.append((wide, call(wide)))
        for route, outs in runs:
            again = call(route)
            torch.cuda.synchronize()
            for name, a, r in zip(names, outs, again):
                assert torch.equal(a, r), f"{route} {name}: a repeat differs"
        refused = [(NO_ROUTE[cell], "route must be")] + (
            [] if cluster else [("cluster", "the cluster route takes")])
        for route, match in refused:
            before = _counts(counts)
            with pytest.raises(ValueError, match=match):
                call(route)
            assert _counts(counts) == before
        torch.cuda.synchronize()
        for route, outs in runs:
            for name, a, r in zip(names, outs, ref):
                assert torch.isfinite(a).all(), (route, name)
                assert self._rel(a, r) <= 1e-4, (route, name,
                                                 self._rel(a, r))
            assert (outs[0][dead] == 0).all(), route
        return got

    def test_streamed_case_reads_w_from_l2(self):
        """Past the widths whose slices of w fit a grid block's shared
        memory, B5 and B6 stream them (the streamed form), on one launch
        of every row; past the rows a streamed block holds, B5 launches
        for a multiple of 16 rows at a time."""
        b, _t, h, _lens = CARD_CASES[STREAMED_CASE]
        for plan in (rnn.fwd_plan, rnn.bwd_plan):
            p = plan(rnn.LSTM_KERNEL, b, h, torch.device("cuda"))
            assert p["route"] == "grid" and p["streamed"], p
            assert p["rows"] == b and p["blocks"] <= p["active"], p
        for plan in (rnn.fwd_plan, rnn.bwd_plan):
            p = plan(rnn.LSTM_KERNEL, 64, 1280, torch.device("cuda"))
            assert p["route"] == "grid" and not p["streamed"], p
        b, _t, h, _lens = CARD_CASES[CHUNKED_CASE]
        p = rnn.fwd_plan(rnn.LSTM_KERNEL, b, h, torch.device("cuda"))
        assert p["route"] == "grid" and p["streamed"], p
        assert 16 <= p["rows"] < b and p["rows"] % 16 == 0, p

    def test_gru_streamed_and_chunked_cases(self):
        """B7 and B8 past the widths whose slices of the weights fit a grid
        block's shared memory stream them from L2, on one launch of every
        row (STREAMED_CASE); past the rows a streamed block holds, both
        launch for a multiple of 16 rows at a time (CHUNKED_CASE); at the
        NMT encoder's h = 1280 and B = 256 the slices are resident."""
        dev = torch.device("cuda")
        b, _t, h, _lens = CARD_CASES[STREAMED_CASE]
        for plan in (rnn.fwd_plan, rnn.bwd_plan):
            p = plan(rnn.GRU_KERNEL, b, h, dev)
            assert p["route"] == "grid" and p["streamed"], p
            assert p["rows"] == b and p["blocks"] <= p["active"], p
            p = plan(rnn.GRU_KERNEL, 256, 1280, dev)
            assert p["route"] == "grid" and not p["streamed"], p
            assert p["rows"] == 256, p
        b, _t, h, _lens = CARD_CASES[CHUNKED_CASE]
        for plan in (rnn.fwd_plan, rnn.bwd_plan):
            p = plan(rnn.GRU_KERNEL, b, h, dev)
            assert p["route"] == "grid" and p["streamed"], p
            assert 16 <= p["rows"] < b and p["rows"] % 16 == 0, p

    @pytest.mark.parametrize("h", [336, 353, 512, 1000, 1280, 2048, 4096])
    def test_gru_grid_plan_is_one_block_an_sm(self, h):
        """Every h past a GRU kernel's cluster route (B7: 352, B8: 320)
        takes the grid route, on G = ceil(h / U) blocks of U = ceil(h /
        SMs) units: never more blocks than the card has SMs, and no more
        than it holds at once (the cooperative launch needs them all)."""
        dev = torch.device("cuda")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for plan, limit in ((rnn.fwd_plan, FWD_CLUSTER_MAX_H["gru"]),
                            (rnn.bwd_plan, CLUSTER_MAX_H["gru"])):
            for b in (1, 80, 256):
                p = plan(rnn.GRU_KERNEL, b, h, dev)
                if h <= limit:
                    assert p["route"] == "cluster", (h, b, p)
                    continue
                units = -(-h // sms)
                assert p["route"] == "grid", (h, b, p)
                assert p["units"] == units, (h, b, p)
                assert p["blocks"] == -(-h // units) <= sms, (h, b, p)
                assert p["blocks"] <= p["active"], (h, b, p)

    @pytest.mark.parametrize("cell", ["lstm", "gru"])
    def test_wave_case_takes_more_clusters_than_the_card_holds(self, cell):
        b, _t, h, _lens = CARD_CASES[WAVE_CASE]
        kernel = rnn.LSTM_KERNEL if cell == "lstm" else rnn.GRU_KERNEL
        for plan in (rnn.fwd_plan, rnn.bwd_plan):
            p = plan(kernel, b, h, torch.device("cuda"))
            assert p["route"] == "cluster" and p["blocks"] > p["active"], p

    def test_autograd_step_launches_each_kernel_once(self):
        lens = torch.from_numpy(LENS).cuda()
        args, dy = _lstm_inputs()
        leaves = [a.cuda().requires_grad_(True) for a in _t(args)]
        gargs, gdy = _gru_inputs()
        gleaves = [a.cuda().requires_grad_(True) for a in _t(gargs)]
        # h = 32: every kernel on the cluster route
        counters = [c for kind in ("fwd", "bwd") for cell in ("lstm", "gru")
                    for c in COUNTERS[kind, cell][:2]]
        grid = [COUNTERS[kind, cell][2] for kind in ("fwd", "bwd")
                for cell in ("lstm", "gru")]
        before, grid_before = _counts(counters), _counts(grid)
        rnn.lstm_fused(*leaves, lens).backward(torch.from_numpy(dy).cuda())
        rnn.gru_fused(*gleaves, lens).backward(torch.from_numpy(gdy).cuda())
        torch.cuda.synchronize()
        assert _counts(counters) == [n + 1 for n in before]
        assert _counts(grid) == grid_before
        for fn, ls, d in ((rnn.lstm_plain, leaves, dy),
                          (rnn.gru_plain, gleaves, gdy)):
            ref = [a.detach().requires_grad_(True) for a in ls]
            fn(*ref, lens).backward(torch.from_numpy(d).cuda())
            for a, r in zip(ls, ref):
                assert self._rel(a.grad, r.grad) <= 1e-4
