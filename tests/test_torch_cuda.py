"""Port kernels K1-K11 on the card against their plain PyTorch versions
(K4 and K5 split-KV with their combine kernel, at pages of 16 and 128
positions; K11 at w = 8 to 128 on both its paths, 4 and 1 channels a
thread; K6, K7 and K8 with and without live-row counts; the streamed
kernel's five modes, K1, K2, K3 (and K8 grouped), K9 and K10, at its tile
edges, byte path and general path, and the template they keep at other
widths; K1-K3, K9, K10 bit-identical across calls; the model zoo's new
shapes: K1 at Mamba-2 780M's in_proj and out_proj, K4 at head dim 160 and
at 24 kv heads of 64, and the Mamba-2 and Jamba smoke configs' launch
counts through the paged runtime).

Marked ``cuda``: skipped (with a reason) where ``torch.cuda.is_available()``
is false.  Run them on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
No JAX here: the card machine has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.apply import pack_array
from repro_torch.core.policy import StruMConfig
from repro_torch.kernels import ops
from repro_torch.kernels import strum_matmul as K

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

pytestmark = pytest.mark.cuda

#: kernel and plain version both accumulate in f32, in different orders
REL_TOL = 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _case(dev, m, k, n, cfg, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    wt = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev, dtype)
    return x, pack_array(wt, cfg)


def _to_cpu(packed):
    return packed._replace(**{f: getattr(packed, f).cpu()
                              for f in ("scale", "mask", "hi", "lo")})


@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (128, 256, 8192),
                                   (4, 8192, 256), (5, 200, 130), (70, 96, 64)])
@pytest.mark.parametrize("cfg,variant", [
    (StruMConfig(method="mip2q", p=0.5, L=5), "onehot"),
    (StruMConfig(method="dliq", p=0.25, q=3), "onehot"),
    (StruMConfig(method="sparsity", p=0.5), "onehot"),
    (StruMConfig(method="mip2q", w=8, p=0.75, L=3), "onehot"),
    (StruMConfig(method="dliq", p=1.0, q=4), "maskfree"),
    (StruMConfig(method="mip2q", p=1.0, L=5), "maskfree"),
    (StruMConfig(method="dliq", w=4, p=1.0, q=3), "maskfree"),
    (StruMConfig(method="dliq", p=0.0), "dense"),
    (StruMConfig(method="mip2q", w=12, p=0.0), "dense"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dev, m, k, n, cfg, variant, dtype):
    x, packed = _case(dev, m, k, n, cfg, dtype)
    before = K.launch_counts[variant]
    y = ops.strum_matmul(x, packed, out_dtype=torch.float32, variant=variant)
    torch.cuda.synchronize()
    assert K.launch_counts[variant] == before + 1
    y_plain = ops.strum_matmul(x.cpu(), _to_cpu(packed), out_dtype=torch.float32,
                               variant=variant)
    err = (y.cpu() - y_plain).abs().max().item()
    assert err <= REL_TOL * y_plain.abs().max().item(), (err, variant)


def test_kernel_rejects_mixed_devices(dev):
    x, packed = _case(dev, 4, 64, 64, StruMConfig())
    with pytest.raises(ValueError):
        K.strum_matmul_onehot(x, packed.mask.cpu(), packed.hi, packed.lo,
                              packed.scale, w=16, n_low=8, q=packed.q,
                              method="mip2q")


# ------------------------------------------------- grouped (MoE): K6, K7, K8

GROUPED_CFGS = [
    (StruMConfig(method="mip2q", p=0.5, L=5), "onehot"),
    (StruMConfig(method="dliq", p=0.25, q=3), "onehot"),
    (StruMConfig(method="sparsity", p=0.5), "onehot"),
    (StruMConfig(method="mip2q", w=8, p=0.75, L=3), "onehot"),
    (StruMConfig(method="dliq", p=1.0, q=4), "maskfree"),
    (StruMConfig(method="mip2q", p=1.0, L=5), "maskfree"),
    (StruMConfig(method="dliq", p=0.0), "dense"),
    (StruMConfig(method="mip2q", w=12, p=0.0), "dense"),
]


def _grouped_case(dev, g, m, k, n, cfg, dtype, seed=0):
    from repro_torch.core.packing import PackedStruM
    from repro_torch.models.quantize import _pack_leaf
    rng = np.random.default_rng(seed)
    wt = torch.from_numpy(rng.normal(size=(g, k, n)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(g, m, k)).astype(np.float32)).to(dev, dtype)
    leaf = _pack_leaf(wt, cfg)
    return x, PackedStruM(method=cfg.method, w=cfg.w, n_low=cfg.n_low, q=cfg.q,
                          L=cfg.L, k_dim=k, **leaf)


# K % w != 0 in every shape (200, 1400 and 40 against w = 16 and 12); G = 3
# and 64; M = 6 and 24 take the kernels' two row tiles
@pytest.mark.parametrize("g,m,k,n", [(3, 5, 200, 130), (64, 6, 1400, 136),
                                     (3, 24, 40, 96)])
@pytest.mark.parametrize("cfg,variant", GROUPED_CFGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_kernel_matches_plain_on_card(dev, g, m, k, n, cfg, variant, dtype):
    x, packed = _grouped_case(dev, g, m, k, n, cfg, dtype)
    name = f"grouped_{variant}"
    before = K.launch_counts[name]
    y = ops.strum_grouped_matmul(x, packed, out_dtype=torch.float32, variant=variant)
    torch.cuda.synchronize()
    assert K.launch_counts[name] == before + 1 and y.shape == (g, m, n)
    y_plain = ops.strum_grouped_matmul(x.cpu(), _to_cpu(packed),
                                       out_dtype=torch.float32, variant=variant)
    err = (y.cpu() - y_plain).abs().max().item()
    assert err <= REL_TOL * y_plain.abs().max().item(), (err, variant)


def test_grouped_kernels_reject_mixed_devices(dev):
    x, packed = _grouped_case(dev, 3, 4, 64, 64, StruMConfig(), torch.float32)
    with pytest.raises(ValueError):
        K.strum_matmul_grouped_onehot(x, packed.mask.cpu(), packed.hi, packed.lo,
                                      packed.scale, w=16, n_low=8, q=packed.q,
                                      method="mip2q")
    with pytest.raises(ValueError):
        K.strum_matmul_grouped_maskfree(x, packed.lo, packed.scale.cpu(), w=16,
                                        q=packed.q, method="mip2q")
    with pytest.raises(ValueError):
        K.strum_matmul_grouped_dense(x, packed.hi.cpu(), packed.scale, w=16)


def test_moe_paged_scheduler_launches_grouped_kernel_on_card(dev):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.engine import build_plan
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import BatchScheduler, Request
    cfg = get_smoke_config("moonshot_v1_16b_a3b")
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    plan = build_plan(params, cfg=StruMConfig(), device=dev)
    assert plan.summary()["variant_distribution"] == {"cuda:onehot": 4,
                                                      "cuda:grouped": 3}
    sched = BatchScheduler(cfg, None, plan=plan, n_slots=2, max_len=48, device=dev,
                           kv_cache=StruMConfig(method="mip2q", p=0.5, L=7))
    rng = np.random.default_rng(0)
    for i, n in enumerate((21, 5)):
        sched.submit(Request(uid=i, prompt=torch.from_numpy(rng.integers(0, 256, n)),
                             max_new_tokens=12))
    K.reset_launch_counts()
    done = sched.run_to_completion()
    assert sorted(len(r.output) for r in done) == [12, 12]
    runs = sched.lane_runs["decode"] + sched.lane_runs["prefill_chunk"]
    assert K.launch_counts["grouped_onehot"] == 3 * cfg.n_layers * runs
    assert K.launch_counts["onehot"] == 4 * cfg.n_layers * runs


def test_moe_paged_scheduler_hands_rows_to_k6_on_card(dev, monkeypatch):
    """Every K6 launch of the Moonshot paged scheduler gets the experts'
    live-row counts (int32 on the card, one per expert, at most the
    capacity), and K6 still launches 3 times per MoE layer per lane run."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.engine import build_plan
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import BatchScheduler, Request
    cfg = get_smoke_config("moonshot_v1_16b_a3b")
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    plan = build_plan(params, cfg=StruMConfig(), device=dev)
    sched = BatchScheduler(cfg, None, plan=plan, n_slots=2, max_len=48, device=dev,
                           kv_cache=StruMConfig(method="mip2q", p=0.5, L=7))
    seen = []
    kernel = K.strum_matmul_grouped_onehot

    def spy(x3, *a, rows=None, **kw):
        y = kernel(x3, *a, rows=rows, **kw)
        seen.append((rows, x3.shape, y))
        return y
    monkeypatch.setattr(K, "strum_matmul_grouped_onehot", spy)
    rng = np.random.default_rng(0)
    for i, n in enumerate((21, 5)):
        sched.submit(Request(uid=i, prompt=torch.from_numpy(rng.integers(0, 256, n)),
                             max_new_tokens=6))
    K.reset_launch_counts()
    done = sched.run_to_completion()
    torch.cuda.synchronize()
    assert sorted(len(r.output) for r in done) == [6, 6]
    runs = sched.lane_runs["decode"] + sched.lane_runs["prefill_chunk"]
    assert K.launch_counts["grouped_onehot"] == 3 * cfg.n_layers * runs == len(seen)
    for rows, shape, y in seen:
        assert rows is not None and rows.dtype == torch.int32 and rows.is_cuda
        assert rows.shape == (shape[0],) and int(rows.max()) <= shape[1]
        for g, cnt in enumerate(rows.tolist()):
            assert not y[g, cnt:].any()


# K6 with live-row counts: N % 16 == 0 (16-byte asynchronous staging) and
# not (byte staging); M = 6, 24 and 70 take the 16-, 32- and 64-row tiles,
# 70 with a count inside its second tile
@pytest.mark.parametrize("g,m,k,n", [(16, 6, 256, 1408), (8, 6, 200, 136),
                                     (4, 24, 1400, 96), (3, 70, 64, 64)])
@pytest.mark.parametrize("cfg", [c for c, _ in GROUPED_CFGS[:4]],
                         ids=lambda c: f"{c.method}_w{c.w}_p{c.p}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_onehot_rows_on_card(dev, g, m, k, n, cfg, dtype):
    x, packed = _grouped_case(dev, g, m, k, n, cfg, dtype)
    rng = np.random.default_rng(g + m)
    counts = rng.integers(0, m + 1, g)
    counts[0], counts[-1] = 0, m                    # an empty and a full expert
    rows = torch.from_numpy(counts.astype(np.int32)).to(dev)
    live = torch.arange(m, device=dev)[None, :] < rows[:, None].long()
    xz = torch.where(live[..., None], x, torch.zeros_like(x))
    before = K.launch_counts["grouped_onehot"]
    y_rows = ops.strum_grouped_matmul(xz, packed, out_dtype=torch.float32, rows=rows)
    y_full = ops.strum_grouped_matmul(xz, packed, out_dtype=torch.float32)
    y_dirty = ops.strum_grouped_matmul(x, packed, out_dtype=torch.float32, rows=rows)
    torch.cuda.synchronize()
    assert K.launch_counts["grouped_onehot"] == before + 3
    want = ops.strum_grouped_matmul(xz.cpu(), _to_cpu(packed), out_dtype=torch.float32,
                                    rows=rows.cpu())
    lim = REL_TOL * want.abs().max().item()
    for y in (y_rows, y_full, y_dirty):
        assert (y.cpu() - want).abs().max().item() <= lim
    for gi, cnt in enumerate(counts.tolist()):
        assert (y_rows[gi, cnt:] == 0).all() and (y_dirty[gi, cnt:] == 0).all()
    assert torch.equal(y_rows, y_dirty)              # x past the count is never read


# K7 with live-row counts at K6's shapes above; w = 8 at q = 3 (fields
# straddle bytes) and w = 12 (no 16-byte stores)
@pytest.mark.parametrize("g,m,k,n", [(16, 6, 256, 1408), (8, 6, 200, 136),
                                     (4, 24, 1400, 96), (3, 70, 64, 64)])
@pytest.mark.parametrize("cfg", [StruMConfig(method="dliq", p=1.0, q=4),
                                 StruMConfig(method="mip2q", p=1.0, L=5),
                                 StruMConfig(method="dliq", w=8, p=1.0, q=3),
                                 StruMConfig(method="dliq", w=12, p=1.0, q=4)],
                         ids=lambda c: f"{c.method}_w{c.w}_q{c.q}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_maskfree_rows_on_card(dev, g, m, k, n, cfg, dtype):
    x, packed = _grouped_case(dev, g, m, k, n, cfg, dtype)
    rng = np.random.default_rng(g + m)
    counts = rng.integers(0, m + 1, g)
    counts[0], counts[-1] = 0, m                    # an empty and a full expert
    rows = torch.from_numpy(counts.astype(np.int32)).to(dev)
    live = torch.arange(m, device=dev)[None, :] < rows[:, None].long()
    xz = torch.where(live[..., None], x, torch.zeros_like(x))
    kw = dict(out_dtype=torch.float32, variant="maskfree")
    before = K.launch_counts["grouped_maskfree"]
    y_rows = ops.strum_grouped_matmul(xz, packed, rows=rows, **kw)
    y_full = ops.strum_grouped_matmul(xz, packed, **kw)
    y_dirty = ops.strum_grouped_matmul(x, packed, rows=rows, **kw)
    torch.cuda.synchronize()
    assert K.launch_counts["grouped_maskfree"] == before + 3
    want = ops.strum_grouped_matmul(xz.cpu(), _to_cpu(packed), rows=rows.cpu(), **kw)
    lim = REL_TOL * want.abs().max().item()
    for y in (y_rows, y_full, y_dirty):
        assert (y.cpu() - want).abs().max().item() <= lim
    for gi, cnt in enumerate(counts.tolist()):
        assert (y_rows[gi, cnt:] == 0).all() and (y_dirty[gi, cnt:] == 0).all()
    assert torch.equal(y_rows, y_dirty)              # x past the count is never read


# ------------------------------------------- 2-D kernels: deterministic split-K

@pytest.mark.parametrize("variant,cfg", [
    ("onehot", StruMConfig(method="mip2q", p=0.5, L=5)),
    ("maskfree", StruMConfig(method="dliq", p=1.0, q=4)),
    ("dense", StruMConfig(method="mip2q", p=0.0, L=5)),
    ("histream", StruMConfig(method="mip2q", p=0.5, L=5)),
    ("maskfree_p", StruMConfig(method="mip2q", p=0.5, L=5))])
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 8192, 2048), (1, 2048, 8192)])
def test_two_d_kernels_are_bit_identical_across_calls_on_card(dev, variant, cfg, m, k, n):
    """K1-K3, K9, K10 at decode shapes where K is split across a cluster:
    two calls on the same inputs give the same bits (the slices are added
    in cluster-rank order, never in arrival order)."""
    x, packed = _case(dev, m, k, n, cfg, torch.bfloat16)
    assert K._split_count(variant, m, n, packed.mask.shape[0], packed.w, True, dev) > 1
    if variant in ("histream", "maskfree_p"):
        def call():
            return ops.strum_matmul_draft(x, packed, mode=variant, out_dtype=torch.float32)
    else:
        def call():
            return ops.strum_matmul(x, packed, out_dtype=torch.float32, variant=variant)
    before = K.launch_counts[variant]
    a, b = call(), call()
    torch.cuda.synchronize()
    assert K.launch_counts[variant] == before + 2
    assert torch.equal(a, b)


# ------------------------------------- K1 and K9: the streamed kernel's edges

#: codecs of the byte path (w = 16, 8 high, 4-bit lo codes that fit int8)
BYTE_CODECS = [StruMConfig(method="mip2q", p=0.5, L=5), StruMConfig(method="dliq", p=0.5, q=4)]
#: codecs of the general path: other widths (w = 24: a K chunk of 120, padded
#: to 128), straddling 3-bit fields, mip2q L = 7 (emits +128), and sparsity
#: (no lo stream: K9's byte path)
GENERAL_CODECS = [StruMConfig(method="mip2q", w=8, p=0.5, L=5),
                  StruMConfig(method="dliq", w=32, p=0.5, q=4),
                  StruMConfig(method="mip2q", w=24, p=0.25, L=5),
                  StruMConfig(method="dliq", p=0.5, q=3),
                  StruMConfig(method="mip2q", p=0.5, L=7),
                  StruMConfig(method="sparsity", p=0.5)]
#: N = 130: unaligned fields, staged with plain loads; N = 2112 crosses a
#: 128-column tile; K = 2045: K % w != 0, x staged with plain loads; K = 2000:
#: 125 w-blocks, K slices of unequal length at every split count here
EDGE_SHAPES = [(2045, 130), (2000, 2112)]


def _codec_id(c):
    return f"{c.method}_w{c.w}_p{c.p}_q{c.q}_L{c.L}"


def _onehot_held(dev, m, k, n, cfg, dtype):
    x, packed = _case(dev, m, k, n, cfg, dtype)
    before = K.launch_counts["onehot"]
    y = ops.strum_matmul(x, packed, out_dtype=torch.float32, variant="onehot")
    torch.cuda.synchronize()
    assert K.launch_counts["onehot"] == before + 1
    y_plain = ops.strum_matmul(x.cpu(), _to_cpu(packed), out_dtype=torch.float32,
                               variant="onehot")
    err = (y.cpu() - y_plain).abs().max().item()
    assert err <= REL_TOL * y_plain.abs().max().item(), err
    return packed


@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 128])
@pytest.mark.parametrize("k,n", EDGE_SHAPES)
@pytest.mark.parametrize("cfg", BYTE_CODECS, ids=_codec_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_k1_byte_path_edges_on_card(dev, m, k, n, cfg, dtype):
    """K1 on the byte path at the main path's row counts and past the
    16-row tile, across column tiles, ragged K and unequal K slices."""
    packed = _onehot_held(dev, m, k, n, cfg, dtype)
    assert K.byte_path_tables(packed.w, packed.n_low, q=packed.q, method=packed.method,
                              L=packed.L) is not None
    if n == 2112 and (dtype == torch.bfloat16 or m < 128):
        # f32 x takes 16-row tiles: at M = 128 its 8 x 17 tiles cover the
        # SMs unsplit; every other case here splits K into unequal slices
        assert K._split_count("onehot", m, n, packed.mask.shape[0], packed.w,
                              dtype == torch.bfloat16, dev) > 1


@pytest.mark.parametrize("m", [4, 17])
@pytest.mark.parametrize("k,n", EDGE_SHAPES)
@pytest.mark.parametrize("cfg", GENERAL_CODECS, ids=_codec_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_k1_general_path_on_card(dev, m, k, n, cfg, dtype):
    packed = _onehot_held(dev, m, k, n, cfg, dtype)
    if cfg.method != "sparsity":
        assert K.byte_path_tables(packed.w, packed.n_low, q=packed.q,
                                  method=packed.method, L=packed.L) is None


@pytest.mark.parametrize("w", [8, 16, 32])
@pytest.mark.parametrize("m", [1, 4, 16, 128])
@pytest.mark.parametrize("k,n", EDGE_SHAPES)
def test_streamed_k9_on_card(dev, w, m, k, n):
    """K9 through the streamed kernel (byte path at w = 16, general path
    otherwise), bf16 x as the draft lane feeds it; lo is never handed over."""
    x, packed = _case(dev, m, k, n, StruMConfig(method="mip2q", w=w, p=0.5, L=5),
                      torch.bfloat16)
    before = K.launch_counts["histream"]
    y = ops.strum_matmul_draft(x, packed, mode="histream", out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert K.launch_counts["histream"] == before + 1
    y_plain = ops.strum_matmul_draft(x.cpu(), _to_cpu(packed), mode="histream",
                                     out_dtype=torch.float32)
    err = (y.cpu() - y_plain).abs().max().item()
    assert err <= REL_TOL * y_plain.abs().max().item(), err


#: K2's streamed codecs: the byte path (w = 16, 4-bit codes that fit int8)
#: and the general path (mip2q L = 7 emits +128; 3-bit fields straddle
#: bytes at w = 8; w = 32)
K2_CODECS = [StruMConfig(method="dliq", p=1.0, q=4), StruMConfig(method="mip2q", p=1.0, L=5),
             StruMConfig(method="mip2q", p=1.0, L=7),
             StruMConfig(method="dliq", w=8, p=1.0, q=3),
             StruMConfig(method="dliq", w=32, p=1.0, q=4)]
#: K10's streamed codecs: the byte path (w = 16, 8 high; lo is never read,
#: so L = 7 and dliq take it too) and the general path (6, 24 and 12 high;
#: w = 24 pads a K chunk of 120 to 128)
K10_CODECS = [StruMConfig(method="mip2q", p=0.5, L=5), StruMConfig(method="dliq", p=0.5, q=4),
              StruMConfig(method="mip2q", p=0.5, L=7),
              StruMConfig(method="mip2q", w=8, p=0.25, L=5),
              StruMConfig(method="dliq", w=32, p=0.75, q=4),
              StruMConfig(method="mip2q", w=24, p=0.5, L=5)]


def _stream_mode_held(dev, name, m, k, n, cfg, dtype):
    """K2 (``name`` "maskfree") or K10 ("maskfree_p") through ``ops`` on
    aligned and unaligned x: one launch each, both within REL_TOL of the
    plain version and bit-identical to each other (x staged by asynchronous
    copies or by plain loads lands as the same tile).  Returns the payload."""
    x, packed = _case(dev, m, k, n, cfg, dtype)
    if name == "maskfree":
        def call(x_, p):
            return ops.strum_matmul(x_, p, out_dtype=torch.float32, variant="maskfree")
    else:
        def call(x_, p):
            return ops.strum_matmul_draft(x_, p, mode="maskfree_p", out_dtype=torch.float32)
    before = K.launch_counts[name]
    y, y_odd = call(x, packed), call(_unaligned(x), packed)
    torch.cuda.synchronize()
    assert K.launch_counts[name] == before + 2
    want = call(x.cpu(), _to_cpu(packed))
    err = (y.cpu() - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), err
    assert torch.equal(y, y_odd)
    return packed


@pytest.mark.parametrize("m", [1, 4, 16, 17, 128])
@pytest.mark.parametrize("k,n", EDGE_SHAPES)
@pytest.mark.parametrize("cfg", K2_CODECS, ids=_codec_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_k2_on_card(dev, m, k, n, cfg, dtype):
    """K2 in the streamed kernel's lo-only mode at the main path's row
    counts and past the 16-row tile, odd N, K % w != 0, unaligned x; the
    byte path exactly where the codes fit int8."""
    packed = _stream_mode_held(dev, "maskfree", m, k, n, cfg, dtype)
    assert K._streamed("maskfree", packed.w)
    byte = K.byte_path_tables(packed.w, packed.n_low, q=packed.q, method=packed.method,
                              L=packed.L, kernel="maskfree") is not None
    assert byte == (cfg.w == 16 and cfg.q == 4 and (cfg.method == "dliq" or cfg.L <= 6))


@pytest.mark.parametrize("m", [1, 4, 16, 17, 128])
@pytest.mark.parametrize("k,n", EDGE_SHAPES)
@pytest.mark.parametrize("cfg", K10_CODECS, ids=_codec_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_k10_on_card(dev, m, k, n, cfg, dtype):
    """K10 in the streamed kernel's hi-only mode at the same edges; the byte
    path at w = 16 with 8 high."""
    packed = _stream_mode_held(dev, "maskfree_p", m, k, n, cfg, dtype)
    assert K._streamed("maskfree_p", packed.w)
    byte = K.byte_path_tables(packed.w, packed.n_low, kernel="maskfree_p") is not None
    assert byte == (cfg.w == 16 and cfg.n_low == 8)


@pytest.mark.parametrize("name,cfg", [
    ("maskfree", StruMConfig(method="dliq", w=4, p=1.0, q=3)),
    ("maskfree", StruMConfig(method="dliq", w=128, p=1.0, q=4)),
    ("maskfree_p", StruMConfig(method="mip2q", w=12, p=0.5, L=5)),
    ("maskfree_p", StruMConfig(method="mip2q", w=128, p=0.5, L=5))],
    ids=lambda v: v if isinstance(v, str) else _codec_id(v))
@pytest.mark.parametrize("m", [4, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k10_keep_the_template_past_the_streamed_widths_on_card(dev, name, cfg, m, dtype):
    """Where the streamed kernel's constraints fail (w % 8 != 0, w > 64) K2
    and K10 run the template, with no byte-path tables."""
    packed = _stream_mode_held(dev, name, m, 2000, 130, cfg, dtype)
    assert not K._streamed(name, packed.w)


# ------------------------------------- K3 and K8: the streamed kernel's dense mode

#: (w, K, route): the byte path at w = 16 and, through the 16-wide view, at w
#: = 8, 12, 32 and 128; the general path at an odd block count of w = 8 and
#: w = 24; the template at w = 12 with a block count not a multiple of 4.
#: K % w != 0 but at w = 8 and (12, 1968).
DENSE_CASES = [(16, 2045, "bytes"), (8, 2000, "bytes"), (12, 1968, "bytes"),
               (32, 2000, "bytes"), (128, 2000, "bytes"), (8, 1992, "general"),
               (24, 1976, "general"), (12, 2000, "template")]


def _dense_held(dev, m, k, n, w, dtype):
    """K3 through ``ops`` on aligned x twice and on unaligned x: three
    launches, within REL_TOL of the plain version, all three bit-identical.
    Returns the payload."""
    x, packed = _case(dev, m, k, n, StruMConfig(method="mip2q", w=w, p=0.0, L=5), dtype)

    def call(x_, p):
        return ops.strum_matmul(x_, p, out_dtype=torch.float32, variant="dense")
    before = K.launch_counts["dense"]
    y, y2, y_odd = call(x, packed), call(x, packed), call(_unaligned(x), packed)
    torch.cuda.synchronize()
    assert K.launch_counts["dense"] == before + 3
    want = call(x.cpu(), _to_cpu(packed))
    err = (y.cpu() - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), err
    assert torch.equal(y, y2) and torch.equal(y, y_odd)
    return packed


@pytest.mark.parametrize("w,k,route", DENSE_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("m", [1, 4, 16, 128])
@pytest.mark.parametrize("n", [130, 2112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_k3_on_card(dev, w, k, route, m, n, dtype):
    """K3 in the streamed kernel's dense mode at byte-path, general-path and
    template widths, odd N, K % w != 0, unaligned x; two calls give the
    same bits."""
    packed = _dense_held(dev, m, k, n, w, dtype)
    assert K._dense_view(w, *packed.hi.shape[:2])[0] == route


#: K8's shapes: Moonshot's wi N at capacity 6 (BM = 16), capacity 24 (BM =
#: 128) with N % 16 != 0 (byte staging), 70 rows (several 16-row tiles for
#: f32 x); (w, K, route) as for K3
@pytest.mark.parametrize("g,m,n", [(16, 6, 1408), (8, 24, 136), (4, 70, 96)])
@pytest.mark.parametrize("w,k,route", DENSE_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_dense_rows_on_card(dev, g, m, n, w, k, route, dtype):
    """K8 with live-row counts: an empty, partial and full expert; rows past
    the count exactly 0, and x there never read on the streamed kernel."""
    x, packed = _grouped_case(dev, g, m, k, n, StruMConfig(method="mip2q", w=w, p=0.0, L=5),
                              dtype)
    assert K._dense_view(w, *packed.hi.shape[1:3])[0] == route
    rng = np.random.default_rng(g + m)
    counts = rng.integers(0, m + 1, g)
    counts[0], counts[-1] = 0, m                    # an empty and a full expert
    rows = torch.from_numpy(counts.astype(np.int32)).to(dev)
    live = torch.arange(m, device=dev)[None, :] < rows[:, None].long()
    xz = torch.where(live[..., None], x, torch.zeros_like(x))
    kw = dict(out_dtype=torch.float32, variant="dense")
    before = K.launch_counts["grouped_dense"]
    y_rows = ops.strum_grouped_matmul(xz, packed, rows=rows, **kw)
    y_full = ops.strum_grouped_matmul(xz, packed, **kw)
    y_dirty = ops.strum_grouped_matmul(x, packed, rows=rows, **kw)
    torch.cuda.synchronize()
    assert K.launch_counts["grouped_dense"] == before + 3
    want = ops.strum_grouped_matmul(xz.cpu(), _to_cpu(packed), rows=rows.cpu(), **kw)
    lim = REL_TOL * want.abs().max().item()
    for y in (y_rows, y_full):
        assert (y.cpu() - want).abs().max().item() <= lim
    for gi, cnt in enumerate(counts.tolist()):
        assert not y_rows[gi, cnt:].any()
    if route != "template":                          # the template does not read rows
        assert torch.equal(y_rows, y_dirty)


def test_dense_kernels_launch_with_null_fields(dev, monkeypatch):
    """K3 and K8 reach the launch with null mask and lo pointers; each runs
    and agrees with its plain version."""
    cfg = StruMConfig(method="mip2q", p=0.0, L=5)
    x, packed = _case(dev, 4, 256, 192, cfg, torch.bfloat16)
    x3, gp = _grouped_case(dev, 3, 6, 256, 192, cfg, torch.bfloat16)
    seen = {}
    launch = K._launch

    def spy(name, x_, mask, hi, lo, scale, **kw):
        seen[name] = (mask is None, hi is None, lo is None)
        return launch(name, x_, mask, hi, lo, scale, **kw)
    monkeypatch.setattr(K, "_launch", spy)
    y3 = K.strum_matmul_dense(x, packed.hi, packed.scale, w=16)
    rows = torch.tensor([6, 2, 0], dtype=torch.int32, device=dev)
    y8 = K.strum_matmul_grouped_dense(x3, gp.hi, gp.scale, w=16, rows=rows)
    torch.cuda.synchronize()
    assert seen == {"dense": (True, False, True), "grouped_dense": (True, False, True)}
    cpu, gcpu = _to_cpu(packed), _to_cpu(gp)
    for y, want in ((y3, K.strum_matmul_dense_plain(x.cpu(), cpu.hi, cpu.scale, w=16)),
                    (y8, K.strum_matmul_grouped_dense_plain(x3.cpu(), gcpu.hi, gcpu.scale,
                                                            rows.cpu(), w=16))):
        assert (y.cpu() - want).abs().max().item() <= REL_TOL * want.abs().max().item()


# ------------------------------------------------ packed KV pages: K4, K5, K11

PAGE_CODECS = [StruMConfig(method="mip2q", p=0.5, L=7),
               StruMConfig(method="dliq", p=0.5, q=4),
               StruMConfig(method="dliq", p=0.25, q=3),      # fields straddle bytes
               StruMConfig(method="sparsity", p=0.5),
               StruMConfig(method="dliq", p=1.0, q=4),
               StruMConfig(method="dliq", p=0.0, q=4)]


def _pages(dev, n_pages, ps, f, cfg, seed=0):
    from repro_torch.engine.cache import encode_page
    rng = np.random.default_rng(seed)
    pages = torch.from_numpy(rng.normal(size=(n_pages, ps, f)).astype(np.float32))
    return {k: v.to(dev) for k, v in encode_page(pages, cfg).items()}


def _floored(pool):
    return {k: v if k == "scale" else ops._min1(v, 2).contiguous()
            for k, v in pool.items()}


# K11 also at w = 8, 64 and 128: the register path holds w <= 64 with at
# most 16 hi and 8 lo rows, the staged path the rest
DECODE_CODECS = PAGE_CODECS + [StruMConfig(method="mip2q", w=8, p=0.5, L=7),
                               StruMConfig(method="mip2q", w=64, p=0.5, L=7),
                               StruMConfig(method="dliq", w=64, p=1.0, q=4),
                               StruMConfig(method="dliq", w=128, p=0.25, q=3),
                               StruMConfig(method="sparsity", w=128, p=0.5),
                               StruMConfig(method="mip2q", w=128, p=0.0, L=7)]
# (codec, page size, F): pages of 16, 32 and 128 positions; F = 42 runs one
# channel a thread
DECODE_CASES = [(cfg, ps, f) for cfg in DECODE_CODECS
                for ps, f in ((16, 2048), (32, 40), (128, 2048), (128, 42)) if ps % cfg.w == 0]


@pytest.mark.parametrize("cfg,ps,f", DECODE_CASES,
                         ids=[f"{c.method}_w{c.w}_p{c.p}_q{c.q}-{ps}-{f}"
                              for c, ps, f in DECODE_CASES])
def test_page_decode_equals_plain_on_card(dev, cfg, ps, f):
    from repro_torch.kernels import strum_decode as D
    pool = _floored(_pages(dev, 5, ps, f, cfg))
    kw = dict(w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    fields = [pool[k] for k in ("mask", "hi", "lo", "scale")]
    before = D.launch_counts["page_decode"]
    got = D.strum_page_decode(*fields, **kw)
    torch.cuda.synchronize()
    assert D.launch_counts["page_decode"] == before + 1
    want = D.strum_page_decode_plain(*[t.cpu() for t in fields], **kw)
    assert torch.equal(got.cpu(), want)             # integer x scale: exact


@pytest.mark.parametrize("cfg", [PAGE_CODECS[0], PAGE_CODECS[2], DECODE_CODECS[-5],
                                 DECODE_CODECS[-3]],
                         ids=lambda c: f"{c.method}_w{c.w}_p{c.p}_q{c.q}")
@pytest.mark.parametrize("offset", [0, 1])
def test_page_decode_vector_widths_on_card(dev, cfg, offset):
    """160 pages of 128 positions at F = 2048 on both paths (4 channels a
    thread), and with the fields at an odd address (one channel a thread,
    never a refusal): exact."""
    from repro_torch.kernels import strum_decode as D
    pool = _floored(_pages(dev, 160, 128, 2048, cfg))
    if offset:
        for k in ("mask", "hi", "lo"):
            t = pool[k]
            buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=dev)
            buf[offset:] = t.reshape(-1)
            pool[k] = buf[offset:].view(t.shape)
    kw = dict(w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    fields = [pool[k] for k in ("mask", "hi", "lo", "scale")]
    got = D.strum_page_decode(*fields, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, D.strum_page_decode_plain(*fields, **kw))


def _attn_case(dev, cfg, kv, r, n_pages=12, ps=16, hd=128, seed=1):
    rng = np.random.default_rng(seed)
    k = _floored(_pages(dev, n_pages, ps, kv * hd, cfg, seed))
    v = _floored(_pages(dev, n_pages, ps, kv * hd, cfg, seed + 1))
    q4 = torch.from_numpy((rng.normal(size=(4, kv, r, hd)) / np.sqrt(hd))
                          .astype(np.float32)).to(dev)
    # slot 0 full, slot 1 empty, slot 2 with -1 tail ids, slot 3 cut by n_valid
    table = torch.tensor([[0, 1, 2, 3, 4], [-1, -1, -1, -1, -1],
                          [5, 6, -1, -1, -1], [7, 8, 9, 10, 11]], dtype=torch.int32)
    n_valid = torch.tensor([5, 0, 4, 2], dtype=torch.int32)
    return q4, k, v, table.to(dev), n_valid.to(dev)


def _close(got, want):
    """Rows with a live page (plain l > 0) hold acc, m, l and acc / l, each
    to REL_TOL x its own largest |plain| there + 1e-6; the other rows are
    the identity partial (m = -1e30, l = 0, acc = 0) exactly."""
    (acc, m, l), (acc_p, m_p, l_p) = (t.cpu() for t in got), want
    live = l_p > 0
    assert torch.equal(l > 0, live) and live.any()
    assert (m[~live] == -1e30).all() and not l[~live].any() and not acc[~live].any()
    for key, a, b in (("acc", acc, acc_p), ("m", m, m_p), ("l", l, l_p),
                      ("out", acc / l[..., None], acc_p / l_p[..., None])):
        a, b = a[live], b[live]
        err = (a - b).abs().max().item()
        assert err <= REL_TOL * b.abs().max().item() + 1e-6, (key, err)


@pytest.mark.parametrize("kv,r", [(16, 1), (16, 16), (4, 7), (4, 112)])
@pytest.mark.parametrize("cfg", PAGE_CODECS[:4], ids=lambda c: f"{c.method}_p{c.p}_q{c.q}")
def test_paged_attention_matches_plain_on_card(dev, cfg, kv, r):
    from repro_torch.kernels import strum_attention as A
    q4, k, v, table, n_valid = _attn_case(dev, cfg, kv, r)
    kw = dict(w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    args = [k[f] for f in ("mask", "hi", "lo", "scale")] + \
        [v[f] for f in ("mask", "hi", "lo", "scale")]
    before = A.launch_counts["paged_attention"]
    got = A.strum_paged_attention(q4, *args, table, n_valid, **kw)
    torch.cuda.synchronize()
    assert A.launch_counts["paged_attention"] == before + 1
    want = A.strum_paged_attention_plain(q4.cpu(), *[t.cpu() for t in args],
                                         table.cpu(), n_valid.cpu(), **kw)
    _close(got, want)
    assert (want[2][1] == 0).all()                  # slot 1 (empty) held as identity


def _long_table(dev, p, n_pages, seed):
    """A (4, p) table over a pool of n_pages: slot 0 full, slot 1 empty,
    slot 2 with -1 holes every third page, slot 3 cut by n_valid."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n_pages, (4, p)).astype(np.int32)
    table[1] = -1
    table[2, ::3] = -1
    n_valid = np.array([p, 0, p, max(1, (2 * p) // 3)], np.int32)
    return torch.from_numpy(table).to(dev), torch.from_numpy(n_valid).to(dev)


@pytest.mark.parametrize("kv,r", [(16, 1), (16, 16), (4, 7), (4, 112)])
@pytest.mark.parametrize("p", [1, 4, 5, 33, 128])
def test_split_kv_attention_across_split_boundaries_on_card(dev, kv, r, p):
    """K4 at OLMo-1B (16 kv heads) and Qwen2-7B (4 kv heads) shapes with
    tables of 1 to 128 page slots, so 1 to several splits with ragged last
    splits: acc, m, l held to the plain version; the combine kernel
    launches once exactly when the table splits."""
    from repro_torch.kernels import strum_attention as A
    cfg = StruMConfig(method="mip2q", p=0.5, L=7)
    n_pages = 48
    q4, k, v, _, _ = _attn_case(dev, cfg, kv, r, n_pages=n_pages, seed=p)
    table, n_valid = _long_table(dev, p, n_pages, seed=p)
    kw = dict(w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    args = [k[f] for f in ("mask", "hi", "lo", "scale")] + \
        [v[f] for f in ("mask", "hi", "lo", "scale")]
    tiles = -(-r // A._row_tile(r, 128))
    pps = A.split_pages(4, p, kv * tiles,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    splits = -(-p // pps)
    before = dict(A.launch_counts)
    got = A.strum_paged_attention(q4, *args, table, n_valid, **kw)
    torch.cuda.synchronize()
    assert A.launch_counts["paged_attention"] == before["paged_attention"] + 1
    assert A.launch_counts["paged_attention_combine"] == \
        before["paged_attention_combine"] + (splits > 1)
    want = A.strum_paged_attention_plain(q4.cpu(), *[t.cpu() for t in args],
                                         table.cpu(), n_valid.cpu(), **kw)
    _close(got, want)
    if splits > 1:      # the CPU mirror of the same split and merge agrees too
        mirror = A.strum_paged_attention_split_plain(
            q4.cpu(), *[t.cpu() for t in args], table.cpu(), n_valid.cpu(),
            pages_per_split=pps, **kw)
        _close(got, mirror)


def _unaligned(t):
    """A contiguous copy of ``t`` whose data pointer is off a 16-byte
    boundary (one element into a larger buffer)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    u = buf[1:1 + t.numel()].view(t.shape)
    u.copy_(t)
    assert u.is_contiguous() and u.data_ptr() % 16
    return u


def _attn_args(cfg, k, v, maskfree):
    names = ("lo", "scale") if maskfree else ("mask", "hi", "lo", "scale")
    kw = dict(w=cfg.w, q=cfg.q, method=cfg.method)
    if not maskfree:
        kw["n_low"] = cfg.n_low
    return [k[f] for f in names] + [v[f] for f in names], kw


def _run_attention(A, maskfree, q4, args, table, n_valid, kw):
    """K4 or K5 on the card (one launch) and its plain version on the CPU."""
    name = "paged_attention_maskfree" if maskfree else "paged_attention"
    kern = A.strum_paged_attention_maskfree if maskfree else A.strum_paged_attention
    plain = A.strum_paged_attention_maskfree_plain if maskfree else \
        A.strum_paged_attention_plain
    before = A.launch_counts[name]
    got = kern(q4, *args, table, n_valid, **kw)
    torch.cuda.synchronize()
    assert A.launch_counts[name] == before + 1
    return got, plain(q4.cpu(), *[t.cpu() for t in args], table.cpu(), n_valid.cpu(),
                      **kw)


@pytest.mark.parametrize("hd", [24, 40, 256])
@pytest.mark.parametrize("maskfree", [False, True], ids=["k4", "k5"])
def test_split_kv_attention_rejects_unaligned_head_dim(dev, hd, maskfree):
    """K4 and K5 no longer refuse a head dim that is not a multiple of 16
    (24, 40) or fields off a 16-byte boundary: those are staged with plain
    loads into the same ring, and match the plain version; hd = 256 is the
    widest they take.  What they still refuse -- a head dim over 256 --
    raises ValueError in the wrapper (the registry never selects them
    there)."""
    from repro_torch.kernels import strum_attention as A
    cfg = StruMConfig(method="dliq", p=1.0, q=4) if maskfree else \
        StruMConfig(method="mip2q", p=0.5, L=7)
    q4, k, v, table, n_valid = _attn_case(dev, cfg, 2, 3, hd=hd)
    args, kw = _attn_args(cfg, k, v, maskfree)
    _close(*_run_attention(A, maskfree, q4, args, table, n_valid, kw))
    odd = [_unaligned(t) for t in args]
    _close(*_run_attention(A, maskfree, q4, odd, table, n_valid, kw))
    q4, k, v, table, n_valid = _attn_case(dev, cfg, 2, 1, n_pages=4, hd=288)
    args, kw = _attn_args(cfg, k, v, maskfree)
    kern = A.strum_paged_attention_maskfree if maskfree else A.strum_paged_attention
    with pytest.raises(ValueError, match="head dim 288"):
        kern(q4, *args, table, n_valid, **kw)


@pytest.mark.parametrize("kv,r", [(16, 1), (16, 16), (4, 7)])
@pytest.mark.parametrize("cfg", [StruMConfig(method="mip2q", p=0.5, L=7),
                                 StruMConfig(method="dliq", p=0.25, q=3),
                                 StruMConfig(method="dliq", p=1.0, q=4),
                                 StruMConfig(method="mip2q", p=1.0, L=7)],
                         ids=lambda c: f"{c.method}_p{c.p}")
def test_paged_attention_page_128_on_card(dev, cfg, kv, r):
    """Pages of 128 positions (nb = 8 blocks of 16): K4 (K5 at p = 1) walks
    each page in two 64-position pieces and matches the plain version."""
    from repro_torch.kernels import strum_attention as A
    maskfree = cfg.p == 1.0
    q4, k, v, table, n_valid = _attn_case(dev, cfg, kv, r, ps=128)
    args, kw = _attn_args(cfg, k, v, maskfree)
    assert k["lo"].shape[1] == 8
    got, want = _run_attention(A, maskfree, q4, args, table, n_valid, kw)
    _close(got, want)
    assert (want[2][1] == 0).all()                  # slot 1 (empty) held as identity


@pytest.mark.parametrize("kv,r", [(16, 1), (4, 7), (4, 112)])
@pytest.mark.parametrize("cfg", [StruMConfig(method="dliq", p=1.0, q=4),
                                 StruMConfig(method="mip2q", p=1.0, L=7)],
                         ids=lambda c: c.method)
def test_paged_attention_maskfree_matches_plain_on_card(dev, cfg, kv, r):
    from repro_torch.kernels import strum_attention as A
    q4, k, v, table, n_valid = _attn_case(dev, cfg, kv, r)
    kw = dict(w=cfg.w, q=cfg.q, method=cfg.method)
    args = [k["lo"], k["scale"], v["lo"], v["scale"]]
    before = A.launch_counts["paged_attention_maskfree"]
    got = A.strum_paged_attention_maskfree(q4, *args, table, n_valid, **kw)
    torch.cuda.synchronize()
    assert A.launch_counts["paged_attention_maskfree"] == before + 1
    want = A.strum_paged_attention_maskfree_plain(
        q4.cpu(), *[t.cpu() for t in args], table.cpu(), n_valid.cpu(), **kw)
    _close(got, want)


@pytest.mark.parametrize("kv,r", [(16, 1), (16, 16), (4, 7), (4, 112)])
@pytest.mark.parametrize("p", [1, 4, 5, 33, 128])
def test_maskfree_split_kv_attention_across_split_boundaries_on_card(dev, kv, r, p):
    """K5, the twin of the K4 case above: tables of 1 to 128 page slots,
    acc, m, l held to the plain version and, with more than one split, to
    the CPU mirror of the same split and merge; K5's combine launches once
    exactly when the table splits, K4's never."""
    from repro_torch.kernels import strum_attention as A
    cfg = StruMConfig(method="dliq", p=1.0, q=4)
    n_pages = 48
    q4, k, v, _, _ = _attn_case(dev, cfg, kv, r, n_pages=n_pages, seed=p)
    table, n_valid = _long_table(dev, p, n_pages, seed=p)
    kw = dict(w=cfg.w, q=cfg.q, method=cfg.method)
    args = [k["lo"], k["scale"], v["lo"], v["scale"]]
    tiles = -(-r // A._row_tile(r, 128))
    pps = A.split_pages(4, p, kv * tiles,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    splits = -(-p // pps)
    before = dict(A.launch_counts)
    got = A.strum_paged_attention_maskfree(q4, *args, table, n_valid, **kw)
    torch.cuda.synchronize()
    assert A.launch_counts["paged_attention_maskfree"] == \
        before["paged_attention_maskfree"] + 1
    assert A.launch_counts["paged_attention_maskfree_combine"] == \
        before["paged_attention_maskfree_combine"] + (splits > 1)
    assert A.launch_counts["paged_attention_combine"] == before["paged_attention_combine"]
    cpu = [t.cpu() for t in args]
    want = A.strum_paged_attention_maskfree_plain(q4.cpu(), *cpu, table.cpu(),
                                                  n_valid.cpu(), **kw)
    _close(got, want)
    if splits > 1:
        mirror = A.strum_paged_attention_split_plain(
            q4.cpu(), *cpu, table.cpu(), n_valid.cpu(), pages_per_split=pps,
            maskfree=True, **kw)
        _close(got, mirror)


def test_paged_scheduler_launches_fused_kernel_on_card(dev):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import strum_attention as A
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import BatchScheduler, Request
    cfg = get_smoke_config("qwen2_7b")
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    sched = BatchScheduler(cfg, params, n_slots=2, max_len=48, device=dev,
                           kv_cache=StruMConfig(method="mip2q", p=0.5, L=7))
    assert sched.cache_stats()["attn_variant"] == "cache:attn_fused"
    rng = np.random.default_rng(0)
    for i, n in enumerate((21, 5)):
        sched.submit(Request(uid=i, prompt=torch.from_numpy(rng.integers(0, 256, n)),
                             max_new_tokens=12))
    A.reset_launch_counts()
    done = sched.run_to_completion()
    assert sorted(len(r.output) for r in done) == [12, 12]
    runs = sched.lane_runs["decode"] + sched.lane_runs["prefill_chunk"]
    assert A.launch_counts["paged_attention"] == cfg.n_layers * runs


def test_paged_scheduler_page_128_launches_k4_on_card(dev):
    """Pages of 128 positions through the paged runtime: the spec selects
    K4, which launches once per layer per lane run and serves every request
    to completion (a prompt long enough to seal a page)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import strum_attention as A
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import BatchScheduler, Request
    cfg = get_smoke_config("qwen2_7b")
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    sched = BatchScheduler(cfg, params, n_slots=2, max_len=384, page_size=128,
                           device=dev, kv_cache=StruMConfig(method="mip2q", p=0.5, L=7))
    assert sched.spec.attn_variant == "cache:attn_fused"
    rng = np.random.default_rng(0)
    for i, n in enumerate((200, 21)):
        sched.submit(Request(uid=i, prompt=torch.from_numpy(rng.integers(0, 256, n)),
                             max_new_tokens=8))
    A.reset_launch_counts()
    done = sched.run_to_completion()
    assert sorted(len(r.output) for r in done) == [8, 8]
    runs = sched.lane_runs["decode"] + sched.lane_runs["prefill_chunk"]
    assert A.launch_counts["paged_attention"] == cfg.n_layers * runs


# ------------------------------------------------- draft kernels: K9, K10

DRAFT_CFGS = [StruMConfig(method=m, w=w, p=p, **kw) for m, kw in
              (("dliq", dict(q=4)), ("mip2q", dict(L=5)), ("sparsity", {}))
              for w in (8, 16, 32) for p in (0.25, 0.5, 0.75)]


@pytest.mark.parametrize("m,k,n", [(1, 2048, 2048), (4, 2048, 8192), (13, 200, 130)])
@pytest.mark.parametrize("cfg", DRAFT_CFGS, ids=lambda c: f"{c.method}_w{c.w}_p{c.p}")
@pytest.mark.parametrize("mode", ["histream", "maskfree_p"])
def test_draft_kernel_matches_plain_on_card(dev, m, k, n, cfg, mode):
    """K9 / K10 through ``ops.strum_matmul_draft`` (bf16 x, as the draft lane
    feeds them); the wrapper hands the kernel a null pointer for every field
    its mode does not stream (lo for K9, mask and lo for K10)."""
    x, packed = _case(dev, m, k, n, cfg, torch.bfloat16)
    before = K.launch_counts[mode]
    y = ops.strum_matmul_draft(x, packed, mode=mode, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert K.launch_counts[mode] == before + 1
    y_plain = ops.strum_matmul_draft(x.cpu(), _to_cpu(packed), mode=mode,
                                     out_dtype=torch.float32)
    err = (y.cpu() - y_plain).abs().max().item()
    assert err <= REL_TOL * y_plain.abs().max().item(), (err, mode)


def test_draft_kernels_launch_with_null_fields(dev, monkeypatch):
    """The fields a draft kernel, or K2, does not stream reach the launch as
    null pointers; the kernel runs and agrees with its plain version."""
    x, packed = _case(dev, 4, 256, 192, StruMConfig(), torch.float32)
    _, p1 = _case(dev, 4, 256, 192, StruMConfig(method="dliq", p=1.0, q=4), torch.float32)
    seen = {}
    launch = K._launch

    def spy(name, x_, mask, hi, lo, scale, **kw):
        seen[name] = (mask is None, hi is None, lo is None)
        return launch(name, x_, mask, hi, lo, scale, **kw)
    monkeypatch.setattr(K, "_launch", spy)
    kw = dict(w=packed.w, n_low=packed.n_low)
    kw2 = dict(w=p1.w, q=p1.q, method=p1.method)
    y9 = K.strum_matmul_histream(x, packed.mask, packed.hi, packed.scale, **kw)
    y10 = K.strum_matmul_maskfree_p(x, packed.hi, packed.scale, **kw)
    y2 = K.strum_matmul_maskfree(x, p1.lo, p1.scale, **kw2)
    torch.cuda.synchronize()
    assert seen == {"histream": (False, False, True), "maskfree_p": (True, False, True),
                    "maskfree": (True, True, False)}
    cpu, cpu1 = _to_cpu(packed), _to_cpu(p1)
    for y, want in ((y9, K.strum_matmul_histream_plain(x.cpu(), cpu.mask, cpu.hi,
                                                        cpu.scale, **kw)),
                    (y10, K.strum_matmul_maskfree_p_plain(x.cpu(), cpu.hi, cpu.scale,
                                                          **kw)),
                    (y2, K.strum_matmul_maskfree_plain(x.cpu(), cpu1.lo, cpu1.scale,
                                                       **kw2))):
        assert (y.cpu() - want).abs().max().item() <= REL_TOL * want.abs().max().item()


@pytest.mark.parametrize("mode", ["histream", "maskfree_p"])
def test_speculative_scheduler_launches_draft_kernel_on_card(dev, mode):
    """The speculative lane on the card: every draft-lane linear on K9 / K10,
    every verify-lane linear on K1, outputs equal to the plain lane's."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.engine import build_plan
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import BatchScheduler, Request
    cfg = get_smoke_config("qwen2_7b")
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    plan = build_plan(params, cfg=StruMConfig(), device=dev)
    outs = {}
    for k in (0, 3):
        sched = BatchScheduler(cfg, None, plan=plan, n_slots=2, max_len=48, device=dev,
                               kv_cache=StruMConfig(method="mip2q", p=0.5, L=7),
                               speculative=k, draft=mode)
        rng = np.random.default_rng(0)
        for i, n in enumerate((21, 5)):
            sched.submit(Request(uid=i, prompt=torch.from_numpy(rng.integers(0, 256, n)),
                                 max_new_tokens=12))
        K.reset_launch_counts()
        outs[k] = {r.uid: r.output for r in sched.run_to_completion()}
        runs = sched.lane_runs
    assert sorted(len(o) for o in outs[3].values()) == [12, 12]
    assert K.launch_counts[mode] == 7 * cfg.n_layers * runs["draft"] > 0
    assert K.launch_counts["onehot"] == 7 * cfg.n_layers * (
        runs["verify"] + runs["prefill_chunk"])
    # the lanes run other kernels at other shapes (K9 / K10 drafts, K1 on
    # verify windows), so a near tie may flip a greedy token between them:
    # agreement is held at 0.9, not bit for bit
    same = np.mean([a == b for u in outs[0] for a, b in zip(outs[0][u], outs[3][u])])
    assert same >= 0.9, same


# ----------------------------------------- the model zoo's shapes: K1, K4

@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("k,n", [(1536, 6448), (3072, 1536)], ids=["in_proj", "out_proj"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_at_mamba2_shapes_on_card(dev, m, k, n, dtype):
    """K1 at Mamba-2 780M's in_proj (N = 6448 = 50 x 128 + 48, a column
    tail at full width) and out_proj, decode and prefill-chunk rows."""
    x, packed = _case(dev, m, k, n, StruMConfig(method="mip2q", p=0.5, L=5), dtype)
    before = K.launch_counts["onehot"]
    y = ops.strum_matmul(x, packed, out_dtype=torch.float32, variant="onehot")
    torch.cuda.synchronize()
    assert K.launch_counts["onehot"] == before + 1
    y_plain = ops.strum_matmul(x.cpu(), _to_cpu(packed), out_dtype=torch.float32,
                               variant="onehot")
    err = (y.cpu() - y_plain).abs().max().item()
    assert err <= REL_TOL * y_plain.abs().max().item(), err


@pytest.mark.parametrize("kv,r,hd", [(8, 4, 160), (24, 1, 64)],
                         ids=["stablelm_hd160", "musicgen_hd64_24kv"])
@pytest.mark.parametrize("cfg", PAGE_CODECS[:2], ids=lambda c: f"{c.method}_p{c.p}_q{c.q}")
def test_paged_attention_zoo_head_dims_on_card(dev, cfg, kv, r, hd):
    """K4 at StableLM-2-12B's head dim 160 (five columns a lane) and
    MusicGen-medium's 24 kv heads of 64."""
    from repro_torch.kernels import strum_attention as A
    q4, k, v, table, n_valid = _attn_case(dev, cfg, kv, r, hd=hd)
    kw = dict(w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    args = [k[f] for f in ("mask", "hi", "lo", "scale")] + \
        [v[f] for f in ("mask", "hi", "lo", "scale")]
    before = A.launch_counts["paged_attention"]
    got = A.strum_paged_attention(q4, *args, table, n_valid, **kw)
    torch.cuda.synchronize()
    assert A.launch_counts["paged_attention"] == before + 1
    want = A.strum_paged_attention_plain(q4.cpu(), *[t.cpu() for t in args],
                                         table.cpu(), n_valid.cpu(), **kw)
    _close(got, want)


@pytest.mark.parametrize("arch", ["mamba2_780m", "jamba_1_5_large_398b"])
def test_ssm_paged_scheduler_launch_counts_on_card(dev, arch):
    """The SSM smoke configs through the paged runtime on the card: K1 on
    every linear, K6 on Jamba's expert stacks and K4 on its attention
    layers, once per layer per lane run; serial and chunked serve every
    request (the same tokens are held on the CPU, at f32)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.engine import build_plan
    from repro_torch.kernels import strum_attention as A
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import BatchScheduler, Request
    cfg = get_smoke_config(arch)
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    plan = build_plan(params, cfg=StruMConfig(), device=dev)
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    linears = sum(2 if cfg.layer_kind(i) == "ssm" else 4 for i in range(cfg.n_layers)) \
        + 3 * sum(cfg.d_ff > 0 and not cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    for mode in ("chunked", "serial"):
        sched = BatchScheduler(cfg, None, plan=plan, n_slots=2, max_len=48, device=dev,
                               prefill=mode, kv_cache=StruMConfig(method="mip2q", p=0.5, L=7))
        rng = np.random.default_rng(0)
        for i, n in enumerate((21, 7)):
            sched.submit(Request(uid=i, prompt=torch.from_numpy(rng.integers(0, 256, n)),
                                 max_new_tokens=6))
        K.reset_launch_counts()
        A.reset_launch_counts()
        done = sched.run_to_completion()
        torch.cuda.synchronize()
        assert sorted(len(r.output) for r in done) == [6, 6]
        runs = sched.lane_runs
        lane = runs["decode"] + runs["prefill_chunk"] + runs["prefill_serial"]
        assert K.launch_counts["onehot"] == linears * lane
        assert K.launch_counts["grouped_onehot"] == 3 * moe * lane
        assert A.launch_counts["paged_attention"] == attn * (runs["decode"]
                                                             + runs["prefill_chunk"])
