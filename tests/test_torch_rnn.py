"""The port's LSTM/GRU sequence ops (`paddle_tpu_torch/ops/rnn.py`) and
sequence ops against the JAX package's, on the CPU.

The same numpy inputs (a numpy seed; B = 5, T = 13, h = 32, lengths
[13, 0, 1, 7, 12]) go through `paddle_tpu/ops/pallas_rnn.py` — its scan
references `lstm_ref`/`gru_ref` and its Pallas kernels in interpret
mode, as `test_pallas_kernels.py` runs them, once with the default VMEM
budget (one time block) and once with the budget patched down so that
the kernels walk two time blocks and carry h/c across the boundary —
and through the port's plain versions and autograd Functions:

- forward: `lstm_plain` (y and the cell sequence c) and `gru_plain`
  within 1e-5 (atol) of both JAX versions;
- backward: `lstm_bwd_plain`/`gru_bwd_plain` and autograd through
  `LstmSeq`/`GruSeq` within 2e-4 (atol) of `jax.vjp` of the
  interpret-mode kernels;
- every function of `ops/sequence_ops.py` against the JAX original
  (exact up to f32 summation order, 1e-6).

`TestOnCard` (marked `cuda`) holds the four Hopper kernels against
their plain versions on the card — each on the route its rule picks
and on the walk, the cluster route bit-identical on a repeat — pins
the width at which each kernel's cluster route gives way to the walk,
and shows that one autograd step launches each kernel once. It skips here; on a machine
with an H100 and no JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_rnn.py`.
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
    rnn.LstmSeq.apply(*leaves, lens).backward(tdy)
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
    rnn.GruSeq.apply(*leaves, lens).backward(tdy)
    assert (rnn.gru_fwd_launches, rnn.gru_bwd_launches) == before
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=2e-4)


def test_entry_points_take_the_plain_versions_on_the_cpu():
    """lstm_fused without gradients is the plain forward; with them the
    autograd Function, whose gradient is autograd's through the plain
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
    for route in (None, "walk", "cluster"):
        for call in _kernel_calls(route):
            with pytest.raises(ValueError, match="unsupported device"):
                call()


@pytest.mark.parametrize("route", ["fast", "Cluster", 0])
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
}
WAVE_CASE = "b512_t6_h256"
# the widest h each kernel takes on the cluster route: its slices of the
# weights and buffers at one batch row a cluster fill a block's 227 KB
# (csrc lstm_seq.cu / gru_seq.cu: FwdSmem, WalkSmem); wider h takes the
# walk
CLUSTER_MAX_H = {"lstm": 320, "gru": 320}          # B6, B8
FWD_CLUSTER_MAX_H = {"lstm": 320, "gru": 352}      # B5, B7
# the launch counters of each kernel: (either route, the cluster route)
COUNTERS = {
    ("fwd", "lstm"): ("lstm_fwd_launches", "lstm_fwd_cluster_launches"),
    ("fwd_infer", "lstm"): ("lstm_fwd_infer_launches",
                            "lstm_fwd_infer_cluster_launches"),
    ("bwd", "lstm"): ("lstm_bwd_launches", "lstm_bwd_cluster_launches"),
    ("fwd", "gru"): ("gru_fwd_launches", "gru_fwd_cluster_launches"),
    ("bwd", "gru"): ("gru_bwd_launches", "gru_bwd_cluster_launches"),
}


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
        its FWD_CLUSTER_MAX_H / CLUSTER_MAX_H, and on the walk: every
        output within 1e-4, the first (y or dx) exactly 0 past len; the
        cluster route bit-identical on a repeat, launches counted by
        route; where h is too wide for it, the cluster route refused with
        nothing counted. Returns the rule's outputs."""
        counts = COUNTERS[kind, cell]
        kernel = rnn.LSTM_KERNEL if cell == "lstm" else rnn.GRU_KERNEL
        b = ref[0].shape[0]
        if kind == "bwd":
            plan, limit = rnn.bwd_plan, CLUSTER_MAX_H[cell]
        else:
            plan, limit = rnn.fwd_plan, FWD_CLUSTER_MAX_H[cell]
        plan = plan(kernel, b, h, ref[0].device)
        cluster = h <= limit
        assert plan["route"] == ("cluster" if cluster else "walk"), plan
        before = [getattr(rnn, c) for c in counts]
        got = call(None)
        assert [getattr(rnn, c) for c in counts] == [
            before[0] + 1, before[1] + cluster]
        runs = [(plan["route"], got)]
        if cluster:
            again = call(None)
            torch.cuda.synchronize()
            for name, a, r in zip(names, got, again):
                assert torch.equal(a, r), f"{name}: a repeat differs"
            runs.append(("walk", call("walk")))
        else:
            before = [getattr(rnn, c) for c in counts]
            with pytest.raises(ValueError, match="the cluster route takes"):
                call("cluster")
            assert [getattr(rnn, c) for c in counts] == before
        torch.cuda.synchronize()
        for route, outs in runs:
            for name, a, r in zip(names, outs, ref):
                assert torch.isfinite(a).all(), (route, name)
                assert self._rel(a, r) <= 1e-4, (route, name,
                                                 self._rel(a, r))
            assert (outs[0][dead] == 0).all(), route
        return got

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
                    for c in COUNTERS[kind, cell]]
        before = [getattr(rnn, c) for c in counters]
        rnn.lstm_fused(*leaves, lens).backward(torch.from_numpy(dy).cuda())
        rnn.gru_fused(*gleaves, lens).backward(torch.from_numpy(gdy).cuda())
        torch.cuda.synchronize()
        assert [getattr(rnn, c) for c in counters] == [
            n + 1 for n in before]
        for fn, ls, d in ((rnn.lstm_plain, leaves, dy),
                          (rnn.gru_plain, gleaves, gdy)):
            ref = [a.detach().requires_grad_(True) for a in ls]
            fn(*ref, lens).backward(torch.from_numpy(d).cuda())
            for a, r in zip(ls, ref):
                assert self._rel(a.grad, r.grad) <= 1e-4
