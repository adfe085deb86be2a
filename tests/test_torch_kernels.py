"""Plain PyTorch versions of kernels K1-K3 vs the reference Pallas kernels.

The same numpy activations and the same packed payload go through
``repro.kernels.ops.strum_matmul(..., interpret=True)`` (the reference
kernels in interpret mode, as tests/test_kernels.py runs them) and
``repro_torch.kernels.ops.strum_matmul`` on CPU tensors, which runs each
kernel's plain version.  Tolerance: rtol 1e-5, atol 1e-4 in f32, the
reference's own kernel-vs-oracle tolerance (the port applies the column
scale after the sum, the reference before it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.kernels import ops as jops
from repro_torch import engine
from repro_torch.core.apply import pack_array
from repro_torch.core.policy import StruMConfig
from repro_torch.kernels import ops
from repro_torch.kernels import strum_matmul as K

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

RTOL, ATOL = 1e-5, 1e-4
FIELDS = ("mask", "hi", "lo", "scale")

CONFIGS = [
    (dict(method="mip2q", p=0.5, L=5), "onehot"),
    (dict(method="dliq", p=0.25, q=3), "onehot"),      # q = 3: fields straddle
    (dict(method="sparsity", w=8, p=0.5), "onehot"),
    (dict(method="mip2q", w=8, p=0.75, L=3), "onehot"),
    (dict(method="dliq", p=1.0, q=3), "maskfree"),
    (dict(method="mip2q", p=1.0, L=5), "maskfree"),
    (dict(method="dliq", w=4, p=1.0, q=4), "maskfree"),
    (dict(method="dliq", p=0.0), "dense"),
    (dict(method="mip2q", w=12, p=0.0), "dense"),
]
# (M, K, N): K % w != 0 for every w above in the first, tile-ragged M and N
SHAPES = [(5, 37, 11), (17, 160, 130)]
CASES = [(c, v, s, "strum_matmul") for c, v in CONFIGS for s in SHAPES]
# decode path: strum_gemv at M <= 8
CASES += [(c, v, (m, 96, 72), "strum_gemv") for (c, v), m in
          zip([CONFIGS[0], CONFIGS[4], CONFIGS[7]], (1, 4, 8))]
IDS = [f"{fn}-{v}-{c['method']}-w{c.get('w', 16)}-p{c['p']}-{s[0]}x{s[1]}x{s[2]}"
       for c, v, s, fn in CASES]


def _inputs(i):
    cfg, _, (m, k, n), _ = CASES[i]
    rng = np.random.default_rng(i)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = pack_array(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)),
                        StruMConfig(**cfg))
    return x, packed


def _to_jax(packed):
    return jpacking.PackedStruM(*packed[:6], **{f: jnp.asarray(getattr(packed, f).numpy())
                                                for f in FIELDS})


@pytest.fixture(scope="module")
def reference_outputs():
    """Every case through the reference kernels, in one jit (one compile)."""
    inputs = [_inputs(i) for i in range(len(CASES))]

    def run(xs, fields):
        out = []
        for (_, variant, _, fn), (_, packed), x, f in zip(CASES, inputs, xs, fields):
            jp = jpacking.PackedStruM(*packed[:6], **dict(zip(FIELDS, f)))
            out.append(getattr(jops, fn)(x, jp, interpret=True, variant=variant))
        return out
    xs = [jnp.asarray(x) for x, _ in inputs]
    fields = [tuple(jnp.asarray(getattr(p, f).numpy()) for f in FIELDS)
              for _, p in inputs]
    return [np.asarray(y) for y in jax.jit(run)(xs, fields)]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_plain_kernel_matches_reference_pallas(reference_outputs, i):
    _, variant, _, fn = CASES[i]
    x, packed = _inputs(i)
    before = dict(K.launch_counts)
    y = getattr(ops, fn)(torch.from_numpy(x), packed, variant=variant)
    assert y.dtype == torch.float32 and y.shape == reference_outputs[i].shape
    np.testing.assert_allclose(y.numpy(), reference_outputs[i], rtol=RTOL, atol=ATOL)
    assert K.launch_counts == before  # the plain path launches nothing


def test_bf16_activations_read_in_their_dtype():
    """bf16 x is read as bf16 and the f32 result cast to ``out_dtype``."""
    x, packed = _inputs(0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = ops.strum_matmul(xb, packed)
    assert y.dtype == torch.bfloat16
    y32 = ops.strum_matmul(xb, packed, out_dtype=torch.float32)
    want = jops.strum_matmul(jnp.asarray(x, jnp.bfloat16), _to_jax(packed),
                             interpret=True, out_dtype=jnp.float32)
    np.testing.assert_allclose(y32.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(y.to(torch.float32).numpy(),
                                  y32.to(torch.bfloat16).to(torch.float32).numpy())


def test_leading_dims_and_padding_contract():
    """(B, S, K) activations flatten into M; padded-K rows meet zero
    activations even though MIP2Q code 0 decodes to +1 there."""
    x, packed = _inputs(0)                       # K = 37, w = 16: 11 pad rows
    assert ops.strum_matmul(torch.from_numpy(x).reshape(5, 1, 37), packed
                            ).shape == (5, 1, 11)
    vals = K.strum_matmul_onehot_plain(torch.eye(48), packed.mask, packed.hi,
                                       packed.lo, torch.ones(1, 11), w=16,
                                       n_low=8, q=packed.q, method="mip2q")
    assert (vals[37:] != 0).any()               # junk rows exist in the payload
    y = ops.strum_matmul(torch.from_numpy(x), packed)
    want = torch.from_numpy(x) @ (vals[:37] * packed.scale)
    torch.testing.assert_close(y, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant,cfg", [
    ("cuda:onehot", dict(method="mip2q", p=0.5)),
    ("cuda:maskfree", dict(method="dliq", p=1.0)),
    ("cuda:dense", dict(method="dliq", p=0.0))])
def test_cuda_variant_on_cpu_tensors_raises(variant, cfg):
    x, packed = _inputs(0)
    packed = pack_array(torch.randn(37, 11), StruMConfig(**cfg))
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.get_variant(variant).fn(torch.from_numpy(x), packed)


def test_wrapper_raises_off_cpu_and_cuda():
    x, packed = _inputs(0)
    with pytest.raises(ValueError, match="no StruM matmul"):
        ops.strum_matmul(torch.from_numpy(x).to("meta"), packed)


def test_variant_preconditions():
    _, packed = _inputs(0)
    for variant in ("maskfree", "dense", "nope"):
        with pytest.raises(ValueError):
            ops.strum_matmul(torch.zeros(2, 37), packed, variant=variant)
    with pytest.raises(ValueError, match="k_dim"):
        ops.strum_matmul(torch.zeros(2, 36), packed)
