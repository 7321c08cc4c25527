"""The w8a8 linear's quantize and rescale (`ops/kernels/w8a8_rows.py`) on
the CPU: the wrappers take their plain versions for CPU tensors and refuse
what the kernels do not take; `linear` on a w8a8 `QuantLinear` stays
bit-equal to the lines it held before the kernels, on rows at the
quantizer's edges; its counters; the launch plans at the benchmark cell's
shapes. The kernels themselves run in `test_torch_cuda.py`."""
import inspect

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mtasr_tpu_torch.models import layers
from mtasr_tpu_torch.ops.int8 import INV127
from mtasr_tpu_torch.ops.kernels import w8a8_rows as wr
from mtasr_tpu_torch.utils import profiling
from mtasr_tpu_torch.utils.quantize import quantize_linear

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

LINEARS = "mtasr.int8.w8a8_linears"
KERNELS = "mtasr.int8.w8a8_kernels"


def linear_before(m, x):
    """`layers.linear` on a w8a8 `QuantLinear`, as it read before the
    kernels."""
    xf = x.float()
    sx = (xf.abs().amax(-1, keepdim=True) * INV127).clamp_min(1e-12)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    acc = layers._int8_matmul(xq.reshape(-1, x.shape[-1]), m.weight_int8)
    acc = acc.reshape(*x.shape[:-1], m.out_features)
    y = (acc.float() * sx * m.scale).to(x.dtype)
    return y if m.bias is None else y + m.bias.to(x.dtype)


def edge_rows(K, dtype, seed=0):
    """[6, K]: an all-zero row (the 1e-12 floor); max|x| 127, so the scale
    is exactly 1, with k + 0.5 ties and +-127; max|x| 254 with odd
    integers (ties at a scale of 2); values of 1e-11 (the floor with a
    nonzero q); a random row; a random row at 1e-3."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((6, K), generator=g)
    k = torch.arange(K)
    x[0] = 0
    x[1] = ((k % 254) - 127 + 0.5).clamp(-127, 127)
    x[1, :2] = torch.tensor([127.0, -127.0])
    x[2] = ((k % 254) * 2 - 253).float()
    x[2, 0] = 254.0
    x[3] = 1e-11 * ((k % 7) - 3).float()
    x[5] *= 1e-3
    return x.to(dtype)


def qlinear(K, N, bias, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((N, K), generator=g) * 0.05
    b = torch.randn((N,), generator=g).to(dtype) if bias else None
    return quantize_linear(w, b, "w8a8")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_edge_rows_reach_the_quantizers_edges(dtype):
    """The rows hold what they claim: exact .5 ties at scales 1 and 2,
    q at +-127, the floor on the zero row and the 1e-11 row."""
    x = edge_rows(256, dtype)
    q, sx = wr.w8a8_quantize_plain(x)
    assert sx[:4, 0].tolist() == pytest.approx([1e-12, 1.0, 2.0, 1e-12])
    r = x.float() / sx
    for row in (1, 2):
        assert int((r[row] - r[row].floor() == 0.5).sum()) > 50
    assert set(q[1].tolist()) >= {127, -127}
    assert not bool(q[0].any()) and bool(q[3].any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_take_the_plain_versions_on_the_cpu(dtype):
    x = edge_rows(128, dtype)
    n_q, n_r = wr.w8a8_quantize.launches, wr.w8a8_rescale.launches
    q, sx = wr.w8a8_quantize(x)
    q0, sx0 = wr.w8a8_quantize_plain(x)
    assert torch.equal(q, q0) and torch.equal(sx, sx0)
    assert q.dtype == torch.int8 and sx.shape == (6, 1)
    m = qlinear(128, 40, True, dtype)
    acc = layers._int8_matmul(q, m.weight_int8)
    y = wr.w8a8_rescale(acc, sx, m.scale, m.bias, dtype)
    assert torch.equal(y, wr.w8a8_rescale_plain(acc, sx, m.scale, m.bias,
                                                 dtype))
    assert y.dtype == dtype
    assert (wr.w8a8_quantize.launches, wr.w8a8_rescale.launches) == \
        (n_q, n_r)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("lead", [(6,), (2, 3)])
def test_linear_is_bit_equal_to_the_lines_it_held(dtype, bias, lead):
    """Edge rows through `linear`, 2-d and 3-d, with and without a bias,
    against the w8a8 branch as it read before the kernels."""
    K, N = 160, 72
    x = edge_rows(K, dtype).reshape(*lead, K)
    m = qlinear(K, N, bias, dtype)
    y = layers.linear(m, x)
    assert y.shape == (*lead, N) and y.dtype == dtype
    assert torch.equal(y, linear_before(m, x))


def test_linear_takes_a_strided_input():
    """A slice of a wider row (a view, not contiguous) is quantized as its
    values."""
    x = edge_rows(200, torch.bfloat16)[:, 20:180]
    m = qlinear(160, 48, True, torch.bfloat16)
    assert not x.is_contiguous()
    assert torch.equal(layers.linear(m, x), linear_before(m, x))


def test_linear_keeps_its_two_argument_signature():
    assert list(inspect.signature(layers.linear).parameters) == ["m", "x"]


@pytest.mark.parametrize("call,err", [
    (lambda x: wr.w8a8_quantize(x[None]), ValueError),            # 3-d
    (lambda x: wr.w8a8_quantize(x[:, :0]), ValueError),           # K = 0
    (lambda x: wr.w8a8_quantize(x.half()), TypeError),
    (lambda x: wr.w8a8_quantize(x.double()), TypeError),
    (lambda x: wr.w8a8_quantize(x.t()), ValueError),              # strided
])
def test_quantize_refuses(call, err):
    x = edge_rows(64, torch.bfloat16)
    with pytest.raises(err, match="w8a8_quantize"):
        call(x)


def _rescale_args():
    q, sx = wr.w8a8_quantize_plain(edge_rows(64, torch.bfloat16))
    m = qlinear(64, 32, True, torch.bfloat16)
    return (layers._int8_matmul(q, m.weight_int8), sx, m.scale, m.bias,
            torch.bfloat16)


@pytest.mark.parametrize("change,err", [
    (lambda a: (a[0].long(),) + a[1:], TypeError),
    (lambda a: (a[0], a[1].double()) + a[2:], TypeError),
    (lambda a: a[:4] + (torch.float16,), TypeError),
    (lambda a: (a[0][0],) + a[1:], ValueError),                  # 1-d acc
    (lambda a: (a[0], a[1][:-1]) + a[2:], ValueError),           # sx rows
    (lambda a: a[:2] + (a[2][:-1],) + a[3:], ValueError),        # scale
    (lambda a: a[:3] + (a[3][:-1],) + a[4:], ValueError),        # bias
    (lambda a: (a[0].t().contiguous().t(),) + a[1:], ValueError),
])
def test_rescale_refuses(change, err):
    with pytest.raises(err, match="w8a8_rescale"):
        wr.w8a8_rescale(*change(_rescale_args()))


def test_counters_count_the_w8a8_linears_under_a_profiler():
    """Under a profiler each w8a8 call counts one linear, and none ran the
    kernels on the CPU; the w8 branch counts nothing; without a profiler
    nothing is kept."""
    x = edge_rows(64, torch.float32)
    m8a8 = qlinear(64, 32, True, torch.float32)
    m8 = quantize_linear(torch.randn(32, 64), None, "w8")
    profiling.take()
    layers.linear(m8a8, x)
    assert profiling.take()[1] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            layers.linear(m8a8, x)
        layers.linear(m8, x)
    counts = profiling.take()[1]
    assert counts.get(LINEARS) == 3 and KERNELS not in counts


@pytest.mark.parametrize("M,K,itemsize,aligned,want", [
    (256, 4096, 2, True, (16, 64, 256)),        # a decode step, K 4096
    (256, 14336, 2, True, (16, 224, 256)),      # the down projection
    (16384, 4096, 2, True, (16, 64, 4224)),     # the prefill: 32 an SM
    (127744, 1024, 2, True, (16, 32, 4224)),    # WavLM over a call
    (8, 4096, 2, True, (16, 64, 8)),            # M 8: a block a row
    (256, 4096, 4, True, (16, 128, 256)),       # float32: 64 bytes a unit
    (256, 4096, 2, False, (1, 256, 256)),       # unaligned: one element
    (64, 1000, 2, True, (1, 64, 64)),           # K not a multiple of 16
    (4, 100000, 2, True, (16, 1024, 4)),        # past the registers
])
def test_quantize_plan(M, K, itemsize, aligned, want):
    plan = wr.quantize_plan(M, K, itemsize, aligned, 132)
    assert tuple(plan) == want
    units = K // plan.unit
    resident = (wr.REGISTER_BYTES // (wr.QUANT_UNIT * itemsize)
                if plan.unit > 1 else wr.SCALAR_RESIDENT)
    # the row fits the block's registers unless the block is full
    assert plan.threads * resident >= units or plan.threads == 1024


@pytest.mark.parametrize("M,N,aligned,want", [
    (256, 4096, True, (8, 4, 256)),
    (256, 1024, True, (8, 1, 256)),
    (256, 32776, True, (8, 33, 64)),            # the head: 32 tiles + 8
    (16384, 14336, True, (8, 14, 151)),
    (8, 4096, True, (8, 4, 8)),
    (256, 1001, True, (1, 8, 256)),             # N not a multiple of 8
    (256, 4096, False, (1, 32, 66)),
])
def test_rescale_plan(M, N, aligned, want):
    plan = wr.rescale_plan(M, N, aligned, 132)
    assert tuple(plan) == want
    assert plan.grid_x * wr.RESCALE_THREADS * plan.unit >= N
