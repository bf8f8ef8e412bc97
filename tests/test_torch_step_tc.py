"""The host side of the tensor-core route of the one-step stack kernels B1
(`fused_stack`, `ops/cuda/ar_step.py`) and B7 (`tp_fused_stack`,
`ops/cuda/ar_tp.py`) on the CPU: their weight streams, the route picked
from the compute dtype and the widths, the shared memory it rests on, and
their plain versions in both summation orders (the tensor cores' and one
fp32 sum per product) against the JAX package's `fused_stack` and
`tp_fused_stack` (Pallas, interpret mode) at bf16. The kernels themselves
run in `tests/test_torch_cuda.py`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import generate as JG
from lb_wavenet_tpu.config import ArchConfig as JArch
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.ops.pallas.ar_step import fused_stack as jfused_stack
from lb_wavenet_tpu.ops.pallas.ar_tp import tp_fused_stack as jtp
from lb_wavenet_tpu_torch import generate as PG
from lb_wavenet_tpu_torch.config import ArchConfig
from lb_wavenet_tpu_torch.models.wavenet import init_params
from lb_wavenet_tpu_torch.ops.cuda import ar_step, ar_tc, ar_tp
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
BF16 = torch.bfloat16
SMALL = ArchConfig(n_blocks=2, n_layers_per_block=4, residual_channels=16,
                   skip_channels=32, gate_channels=16, compute_dtype="bfloat16")
WAVENET30 = ArchConfig(n_blocks=3, n_layers_per_block=10, residual_channels=64,
                       skip_channels=256, gate_channels=64, compute_dtype="bfloat16")
# The same bf16-rounded operands summed in another order: a flipped rounding
# of one activation moves a skip value by ~1e-2 (as tests/test_torch_tc.py
# holds mega's and turbo's logits).
SKIP_ATOL = 2e-2


def _cut(lp: dict, half) -> dict:
    """Layer params on model rank `half` of two (None: the whole skip)."""
    if half is None:
        return lp
    s = lp["w_skip"].shape[-1] // 2
    sl = slice(half * s, (half + 1) * s)
    return {**lp, "w_skip": lp["w_skip"][..., sl], "b_skip": lp["b_skip"][..., sl]}


@pytest.mark.parametrize("arch", [SMALL, WAVENET30], ids=["small", "wavenet30"])
@pytest.mark.parametrize("half", [None, 0])
def test_b1_stream_is_the_packed_layer_weights(arch, half):
    """B1's stream: pack_stream of the per-layer [w_cur ; w_prev] (2C, 2G)
    and [w_res | w_skip] (G, C+S), S the skip slice given; each packed
    matrix unpacks to its source (bf16-rounded), and the (M, K) table names
    the 2L products in order."""
    lp = _cut(init_params(3, arch, "cpu")["layers"], half)
    n_layers, c, g = len(arch.dilations), arch.residual_channels, arch.gate_channels
    s = lp["w_skip"].shape[-1]
    ops = ar_tc.pack_layers(ar_tc.layer_stream(lp), lp["b"],
                            torch.cat([lp["b_res"], lp["b_skip"]], 1), "cpu")
    assert ops["prods"].tolist() == [[2 * g, 2 * c], [c + s, g]] * n_layers
    assert ops["bg"].shape == (n_layers, 2 * g) and ops["brs"].shape == (n_layers, c + s)
    off = 0
    for l in range(n_layers):
        for w in (torch.cat([lp["w_cur"][l], lp["w_prev"][l]], 0),
                  torch.cat([lp["w_res"][l], lp["w_skip"][l]], 1)):
            k, m = w.shape
            part = ops["wpk"][off: off + k * m].reshape(k // 16, m // 16, 32, 8)
            assert torch.equal(ar_tc.unpack_mma(part), w.to(BF16))
            off += k * m
    assert off == ops["wpk"].numel()


@pytest.mark.parametrize("arch", [SMALL, WAVENET30], ids=["small", "wavenet30"])
@pytest.mark.parametrize("half", [None, 0, 1])
def test_b7_stream_from_feature_major_views_equals_the_layer_stream(arch, half):
    """B7 packs from the feature-major views (generate._tp_weights); its
    stream equals the one built from the same skip slice of the layer
    params, for S_l = S and both halves."""
    p = init_params(4, arch, "cpu")
    lp = _cut(p["layers"], half)
    fm = PG._tp_weights(p, lp, BF16)
    mats = ar_tc.fm_layer_stream(fm)
    want = ar_tc.layer_stream(lp)
    assert len(mats) == len(want) == 2 * len(arch.dilations)
    assert all(torch.equal(a, b) for a, b in zip(mats, want))
    a, b = ar_tc.pack_stream(mats, "cpu"), ar_tc.pack_stream(want, "cpu")
    assert torch.equal(a["wpk"], b["wpk"]) and torch.equal(a["prods"], b["prods"])


ROUTES = [
    # (name, C, G, S the kernel is given, dtype, route)
    ("small", 16, 16, 32, BF16, "tensor_cores"),
    ("small_half", 16, 16, 16, BF16, "tensor_cores"),
    ("wavenet30", 64, 64, 256, BF16, "tensor_cores"),
    ("wavenet30_half", 64, 64, 128, BF16, "tensor_cores"),
    ("stress", 64, 64, 512, BF16, "tensor_cores"),
    ("stress_half", 64, 64, 256, BF16, "tensor_cores"),
    ("c_plus_s_768", 64, 64, 704, BF16, "tensor_cores"),
    ("stress_third", 64, 64, 512 // 3, BF16, "cuda_cores"),
    ("s_l_24", 64, 64, 24, BF16, "cuda_cores"),
    ("c_plus_s_above_768", 64, 64, 720, BF16, "cuda_cores"),
    ("c24", 24, 24, 256, BF16, "cuda_cores"),
    ("g400", 64, 400, 256, BF16, "cuda_cores"),
    ("wavenet30_fp32", 64, 64, 256, torch.float32, "cuda_cores"),
    ("stress_fp32", 64, 64, 512, torch.float32, "cuda_cores"),
]


@pytest.mark.parametrize("name,c,g,s,dt,want", ROUTES, ids=[r[0] for r in ROUTES])
def test_stack_route_from_dtype_and_widths(name, c, g, s, dt, want):
    """ar_tc.stack_route: bf16 with C, G and the given S (a rank's skip
    slice) multiples of 16, C+S <= 768 and G <= 384 goes to the tensor
    cores; fp32, an S_l split 3 ways, C+S_l > 768 and other widths keep the
    CUDA-core kernels. The plain versions sum as the tensor cores do only on
    a CUDA tensor on that route."""
    assert ar_tc.stack_route(c, g, s, 30, dt) == want
    assert ar_tc.stack_default_order(c, g, s, 30, dt, torch.device("cuda")) == \
        (want == "tensor_cores")
    assert not ar_tc.stack_default_order(c, g, s, 30, dt, torch.device("cpu"))


def test_b1_route_reads_the_skip_slice_not_the_arch():
    """Under a model axis pallas_stack_step hands fused_stack one rank's
    skip slice: the route is decided from that S. A slice of a width the
    tiles take (S/2 = 128) keeps the tensor cores; a 3-way split (S = 85,
    86) leaves them, whatever arch.skip_channels says."""
    p = init_params(5, WAVENET30, "cpu")
    for cols, want in ((slice(0, 128), "tensor_cores"), (slice(0, 85), "cuda_cores"),
                       (slice(85, 171), "cuda_cores")):
        lp = {**p["layers"], "w_skip": p["layers"]["w_skip"][..., cols]}
        n_layers, c, two_g = lp["w_cur"].shape
        assert ar_tc.stack_route(c, two_g // 2, lp["w_skip"].shape[-1], n_layers, BF16) == want


@pytest.mark.parametrize("c,g,s,n_layers", [(16, 16, 32, 8), (64, 64, 256, 30),
                                            (64, 64, 512, 30), (64, 64, 704, 30)])
def test_stack_smem_fits_the_ring_beside_the_tile(c, g, s, n_layers):
    """stack_smem: the carve's bytes are the activations (h, the skip sum,
    two tap buffers, the dilations, the bf16 [h | tap] and gate tiles, each
    aligned to 16 bytes, and the ring's barriers) plus whole 32 KB slots,
    as many as fit in an H100 block's 232,448 bytes, at most 6."""
    total, slots = ar_tc.stack_smem(c, g, s, n_layers)
    fixed = total - slots * ar_tc.SLOT
    tb = ar_tc.TB
    acts = (16 * ar_tc.MAX_SLOTS + 4 * tb * (3 * c + s) + 4 * n_layers
            + 2 * tb * (2 * c + 8 + g + 8))
    assert acts <= fixed <= acts + 15 * 10   # at most 15 bytes of alignment per piece
    assert slots == min(ar_tc.MAX_SLOTS, (ar_tc.SMEM_MAX - fixed) // ar_tc.SLOT)
    assert 2 <= slots and total <= ar_tc.SMEM_MAX


def _jax_pair(seed):
    jarch = JArch(**dataclasses.asdict(SMALL))
    jp = jinit(jax.random.key(seed), jarch)
    return jp, jarch, params_from_jax(jax.tree.map(np.asarray, jp))


def _written(arch, t):
    slots = [o + t % d for o, d in zip(ar_step.buffer_offsets(arch), arch.dilations)]
    written = np.zeros(sum(arch.dilations), bool)
    written[slots] = True
    return slots, written


@pytest.mark.parametrize("half", [None, 0, 1])
@pytest.mark.parametrize("order", ["tensor_cores", "cpu_default"])
def test_b1_plain_versions_match_jax_at_bf16(half, order):
    """fused_stack's plain version, summed as the tensor cores sum on the
    card or as the CPU entry point sums by default (one fp32 product),
    against JAX's fused_stack (interpret mode) at C = G = 16, S = 32 and on
    each 16-wide skip half, bf16: the rows no layer wrote and layer 0's
    slot exactly, the other written rows and the skip sum within 2e-2."""
    jp, jarch, pp = _jax_pair(6)
    jlp = _cut(jp["layers"], half)
    lp = _cut(pp["layers"], half)
    b, c, t = 6, SMALL.residual_channels, 1001
    rng = np.random.default_rng(7)
    bufs = rng.standard_normal((sum(SMALL.dilations), b, c)).astype(np.float32)
    h0 = rng.standard_normal((b, c)).astype(np.float32)
    slots, written = _written(SMALL, t)
    jslots = jnp.asarray(slots, jnp.int32)
    jb, js = jfused_stack(jlp, jarch, jnp.asarray(h0), jnp.asarray(bufs), jslots, interpret=True)
    ring = torch.from_numpy(bufs.copy())
    if order == "cpu_default":
        pb, ps = ar_step.fused_stack(lp, SMALL, torch.from_numpy(h0), ring, t)
    else:
        def mm(x, w):
            return ar_tc.tc_mm(x.to(BF16).float(), w.to(BF16).float())
        pb, ps = ar_step.fused_stack_plain(lp, SMALL, torch.from_numpy(h0), ring, t, mm)
    assert pb is ring and ps.shape == (b, lp["w_skip"].shape[-1])
    np.testing.assert_array_equal(pb.numpy()[~written], bufs[~written])
    np.testing.assert_array_equal(pb.numpy()[slots[0]], h0)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=SKIP_ATOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=SKIP_ATOL)


@pytest.mark.parametrize("half", [None, 0, 1])
@pytest.mark.parametrize("order", ["tensor_cores", "cpu_default"])
def test_b7_plain_versions_match_jax_at_bf16(half, order):
    """tp_fused_stack's plain version in both orders against JAX's
    tp_fused_stack (interpret mode) at C = G = 16, S = 32 and on each
    16-wide skip half (S_l = 16), bf16, B = 4: the rows no layer wrote and
    layer 0's slot exactly, the rest and the local skip within 2e-2; the
    halves' skips concatenate to the whole one's within the same limit."""
    jp, _, pp = _jax_pair(8)
    jp = {**jp, "layers": _cut(jp["layers"], half)}
    lp = _cut(pp["layers"], half)
    b, c, t = 4, SMALL.residual_channels, 777
    rng = np.random.default_rng(9)
    bufs = rng.standard_normal((sum(SMALL.dilations), c, b)).astype(np.float32)
    h0 = rng.standard_normal((c, b)).astype(np.float32)
    slots, written = _written(SMALL, t)
    jarch = JArch(**dataclasses.asdict(SMALL))
    jb, js = jtp(JG._tp_weights(jp, jp["layers"], False), jarch, jnp.asarray(h0),
                 jnp.asarray(bufs), jnp.asarray(slots, jnp.int32), interpret=True)
    fm = PG._tp_weights(pp, lp, BF16)
    ring = torch.from_numpy(bufs.copy())
    if order == "cpu_default":
        pb, ps = ar_tp.tp_fused_stack(fm, SMALL, torch.from_numpy(h0), ring, t)
    else:
        pb, ps = ar_tp.tp_fused_stack_plain(fm, SMALL, torch.from_numpy(h0), ring, t,
                                            tensor_cores=True)
    assert pb is ring and ps.shape == (lp["w_skip"].shape[-1], b)
    np.testing.assert_array_equal(pb.numpy()[~written], bufs[~written])
    np.testing.assert_array_equal(pb.numpy()[slots[0]], h0)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=SKIP_ATOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=SKIP_ATOL)


@pytest.mark.parametrize("tensor_cores", [True, False])
def test_b7_halves_concatenate_to_the_whole_skip(tensor_cores):
    """A skip column's sum does not depend on the other columns of the
    product: in either order the two halves' local skips concatenate to
    the whole width's exactly, and the ring they leave is the same."""
    p = init_params(10, SMALL, "cpu")
    rng = np.random.default_rng(10)
    b, c = 5, SMALL.residual_channels
    bufs = torch.from_numpy(rng.standard_normal((sum(SMALL.dilations), c, b)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((c, b)).astype(np.float32))
    out = {}
    for half in (None, 0, 1):
        fm = PG._tp_weights(p, _cut(p["layers"], half), BF16)
        out[half] = ar_tp.tp_fused_stack_plain(fm, SMALL, h0, bufs.clone(), 31,
                                               tensor_cores=tensor_cores)
    assert torch.equal(torch.cat([out[0][1], out[1][1]]), out[None][1])
    assert torch.equal(out[0][0], out[None][0]) and torch.equal(out[1][0], out[None][0])
