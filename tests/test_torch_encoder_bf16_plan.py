"""The bf16 encoder layer's launch plan and scratch layout
(tip_tpu_torch/ops/encoder_train.py: encoder_bf16_plan, bf16_scratch_layout),
which csrc/encoder_train.cu's bf16 entry points take as the wrapper passes
them: pure functions of the shapes, checked here on the CPU."""

import math
import re
from pathlib import Path

import pytest
import torch

from tip_tpu_torch.ops import encoder_train as ET

T = 40
WIDTHS = {"model": (256, 1024, 16), "small": (32, 64, 4)}
PLAN_B = (1, 3, 9, 64, 256)


def intervals_cover(starts_ends, n):
    """The half-open intervals, in order, cover [0, n) exactly once."""
    at = 0
    for a, b in starts_ends:
        if a != at or b <= a:
            return False
        at = b
    return at == n


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("B", PLAN_B)
def test_plan_covers_every_output_of_every_product_once(B, width):
    d, ff, _ = WIDTHS[width]
    plans = ET.encoder_bf16_plan(B, T, d, ff)
    assert [p.name for p in plans] == [name for name, _, _ in ET.PRODUCTS]
    R = B * T
    want = {"qkv": (R, 3 * d, d), "out": (R, d, d), "ff1": (R, ff, d),
            "ff2": (R, d, ff), "dh1": (R, ff, d), "dw_f2": (ff, d, R),
            "dy1": (R, d, ff), "dw_f1": (d, ff, R), "datt": (R, d, d),
            "dw_o": (d, d, R), "dx": (R, d, 3 * d), "dw_qkv": (d, 3 * d, R)}
    for p in plans:
        assert (p.M, p.N, p.K) == want[p.name], p.name
        assert (p.bm, p.bn) in ((64, 64), (64, 128), (128, 128))
        assert p.kchunk % ET.GEMM_BK == 0
        rows = [(i * p.bm, min(p.M, (i + 1) * p.bm))
                for i in range(math.ceil(p.M / p.bm))]
        cols = [(j * p.bn, min(p.N, (j + 1) * p.bn))
                for j in range(math.ceil(p.N / p.bn))]
        ks = [(s * p.kchunk, min(p.K, (s + 1) * p.kchunk))
              for s in range(p.splits)]
        # the grid (columns, rows, splits) is the product of three
        # partitions, so it covers each output's sum over K exactly once
        assert intervals_cover(rows, p.M), p
        assert intervals_cover(cols, p.N), p
        assert intervals_cover(ks, p.K), p
        assert p.ctas == len(rows) * len(cols) * len(ks)
        # a tile's splits are one cluster: at most 16 blocks; a 128-row
        # tile is never split
        assert 1 <= p.splits <= ET.MAX_SPLITS == 16
        assert p.bm == 64 or p.splits == 1


@pytest.mark.parametrize("B", (1, 64))
def test_plan_fills_the_card_at_b1_and_b64_or_says_why(B):
    d, ff, _ = WIDTHS["model"]
    for p in ET.encoder_bf16_plan(B, T, d, ff):
        if p.ctas >= ET.SM_COUNT:
            assert p.reason == "", p
            continue
        # fewer blocks only where no plan gives more: the narrow tiles
        # and as many splits as K's 64-deep slices allow
        kb = math.ceil(p.K / ET.GEMM_BK)
        most = math.ceil(kb / math.ceil(kb / min(kb, ET.MAX_SPLITS)))
        assert (p.bm, p.bn) == (64, 64) and p.splits == most, p
        assert str(p.ctas) in p.reason and str(p.K) in p.reason, p
    if B == 64:
        assert all(p.ctas >= ET.SM_COUNT
                   for p in ET.encoder_bf16_plan(B, T, d, ff))


def test_split_order_depends_on_the_shapes_alone():
    d, ff, _ = WIDTHS["model"]
    for B in PLAN_B:
        a = ET.encoder_bf16_plan(B, T, d, ff)
        b = ET.encoder_bf16_plan(B, T, d, ff)
        assert a == b
        ints = ET.plan_ints(a)
        assert list(ET._plan_arg(B, T, d, ff)) == ints
        assert len(ints) == 4 * len(ET.PRODUCTS)
        # the same rows B*T give the same plan whatever B and T are
        assert ET.encoder_bf16_plan(B * 2, T // 2, d, ff) == a
    # split into chunks as even as they go: the last is no emptier than
    # one slice short of the others
    for p in ET.encoder_bf16_plan(256, T, d, ff):
        if p.splits > 1:
            last = p.K - (p.splits - 1) * p.kchunk
            assert 0 < last <= p.kchunk


FWD_NAMES = ("qkv", "att", "pre", "y1", "y1b", "f1d", "pre2")
F32_NAMES = {"pre", "y1", "pre2", "xhat1", "rs1", "xhat2", "rs2", "dr2",
             "dy1", "dr1", "cp_ln2", "cp_dh1", "cp_ln1", "cp_dqkv"}


@pytest.mark.parametrize("backward", (False, True))
@pytest.mark.parametrize("B", (1, 3, 64, 256))
def test_bf16_scratch_layout_is_aligned_disjoint_and_holds_no_image(
        B, backward):
    d, ff, nh = WIDTHS["model"]
    lay = ET.bf16_scratch_layout(B, T, d, ff, backward)
    names = list(lay.arrays)
    assert names == [n for n, _, _ in ET.BF16_ARRAYS][:len(names)]
    assert len(names) == (len(ET.BF16_ARRAYS) if backward
                          else ET.BF16_FWD_ARRAYS)
    assert tuple(names[:len(FWD_NAMES)]) == FWD_NAMES
    spans = []
    for name, (off, dtype, shape) in lay.arrays.items():
        assert off % 16 == 0, name
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        spans.append((off, off + n, name))
        # f32 only where f32 is read; bf16 where a product reads it
        assert (dtype == torch.float32) == (name in F32_NAMES), name
    spans.sort()
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert end <= start, (a, b)
    assert lay.end == spans[-1][1]
    # no widened image of x, dy or a weight: no f32 array of their shapes
    # and none named for them
    N = B * T
    images = {(N, d), (d, 3 * d), (3 * d,), (d, d), (d,), (d, ff), (ff,),
              (ff, d)}
    for name, (_, dtype, shape) in lay.arrays.items():
        assert name not in ("x", "dy", "dx") and not name.startswith(
            ("img", "w_", "b_", "g_"))
        if dtype == torch.float32 and shape in images:
            assert name in F32_NAMES, name
    # the bias gradients' partial sums: a row a block of their producer
    if backward:
        nl, nm = math.ceil(N / ET.LN_ROWS), math.ceil(N / ET.GEMM_BM)
        assert lay.arrays["cp_ln2"][2] == lay.arrays["cp_ln1"][2] == (3, nl,
                                                                       d)
        assert lay.arrays["cp_dh1"][2] == (nm, ff)
        assert lay.arrays["cp_dqkv"][2] == (B, 3 * d)


def test_wrapper_allocates_the_layouts_end():
    d, ff, nh = WIDTHS["model"]
    for B in (1, 3, 64):
        for backward in (False, True):
            lay = ET.bf16_scratch_layout(B, T, d, ff, backward)
            buf = ET.alloc_scratch(lay, "cpu")
            assert buf.dtype == torch.uint8 and buf.numel() == lay.end
        x = torch.zeros(B, T, d, dtype=torch.bfloat16)
        ws = ET.pack_layer_weights(
            {f"l.{k}": torch.zeros(s) for k, s in (
                ("w_q", (d, d)), ("w_k", (d, d)), ("w_v", (d, d)),
                ("b_q", (d,)), ("b_k", (d,)), ("b_v", (d,)),
                ("out_proj.w", (d, d)), ("out_proj.b", (d,)),
                ("ff1.w", (d, ff)), ("ff1.b", (ff,)), ("ff2.w", (ff, d)),
                ("ff2.b", (d,)), ("ln1_s", (d,)), ("ln1_b", (d,)),
                ("ln2_s", (d,)), ("ln2_b", (d,)))}, "l.", torch.bfloat16)
        lay, buf = ET.k12_scratch(x, ws, nh)
        assert buf.numel() == lay.end
        assert lay.end == ET.bf16_scratch_layout(B, T, d, ff, True).end


def test_layout_views_are_the_arrays_and_do_not_overlap():
    d, ff, _ = WIDTHS["small"]
    lay = ET.bf16_scratch_layout(3, 10, d, ff, True)
    buf = torch.zeros(lay.end, dtype=torch.uint8)
    views = lay.views(buf)
    for i, (name, v) in enumerate(views.items()):
        off, dtype, shape = lay.arrays[name]
        assert v.dtype == dtype and tuple(v.shape) == shape, name
        v.fill_(i + 1)
    for i, (name, v) in enumerate(views.items()):
        assert bool((v == i + 1).all()), name
    ptrs = lay.pointers(buf)
    assert [p - buf.data_ptr() for p in ptrs] == [
        off for off, _, _ in lay.arrays.values()]


def test_f32_scratch_layout_follows_the_kernels_carve():
    # the f32 K11's and K12's arrays as the kernels read their addresses,
    # each 16-byte aligned and disjoint, K12's partial sums last
    B, d, ff = 3, 32, 64
    N = B * T
    fwd = ET.f32_scratch_layout(B, T, d, ff)
    bwd = ET.f32_scratch_layout(B, T, d, ff, 1000)
    names = [n for n, _ in ET.F32_ARRAYS]
    assert list(fwd.arrays) == names[:ET.F32_FWD_ARRAYS]
    assert list(bwd.arrays) == names + ["part"]
    assert bwd.arrays["part"][2] == (1000,)
    assert bwd.arrays["qkv"][2] == (N, 3 * d)
    assert bwd.arrays["f1"][2] == (N, ff) and bwd.arrays["rs1"][2] == (N,)
    spans = []
    for name, (off, dtype, shape) in bwd.arrays.items():
        assert dtype == torch.float32 and off % 16 == 0, name
        spans.append((off, off + 4 * math.prod(shape)))
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start < end + 16
    assert bwd.end == spans[-1][1]
    # K11 takes K12's first arrays where K12 keeps them
    assert all(bwd.arrays[n] == fwd.arrays[n] for n in fwd.arrays)


def enum_names(source, first):
    """The names of the C enum in ``source`` whose first entry is
    ``first``, in order, their k prefix dropped and the camel case turned
    to snake case; the marker entries (k..Arrays, kProducts and aliases)
    left out."""
    body = re.search(r"enum \{\s*(" + first + r"\b.*?)\};", source,
                     re.S).group(1)
    out = []
    for entry in body.replace("\n", " ").split(","):
        name = entry.split("=")[0].strip()
        if not name or "=" in entry or name.endswith(("Arrays", "Products")):
            continue
        out.append(re.sub(r"(?<!^)(?=[A-Z])", "_", name[1:]).lower())
    return out


def test_scratch_arrays_and_products_follow_the_kernels_enums():
    src = (Path(ET.__file__).parents[1] / "csrc" /
           "encoder_train.cu").read_text()
    bf16 = enum_names(src, "kQkv")
    # kY aliases kFwdArrays: the backward's arrays follow the forward's
    assert bf16[:ET.BF16_FWD_ARRAYS] == [n for n, _, _ in
                                         ET.BF16_ARRAYS][:ET.BF16_FWD_ARRAYS]
    assert ["y"] + bf16[ET.BF16_FWD_ARRAYS:] == [
        n for n, _, _ in ET.BF16_ARRAYS][ET.BF16_FWD_ARRAYS:]
    f32 = [n[2:] for n in enum_names(src, "kFQkv")]    # kF.. prefix
    names = [n for n, _ in ET.F32_ARRAYS]
    assert f32[:ET.F32_FWD_ARRAYS] == names[:ET.F32_FWD_ARRAYS]
    assert ["y"] + f32[ET.F32_FWD_ARRAYS:] == names[ET.F32_FWD_ARRAYS:] + [
        "part"]
    products = [n[2:] for n in enum_names(src, "kPQkv")]   # kP.. prefix
    assert products == [n for n, _, _ in ET.PRODUCTS]


@pytest.mark.parametrize("T_, d, nh", [(100, 256, 16), (133, 256, 16),
                                       (40, 256, 2), (17, 832, 1)])
def test_bf16_wrapper_takes_long_windows_and_wide_heads(T_, d, nh):
    # windows past 64 and heads wider than 64 go to the kernel (its
    # attention takes 64 keys and 64 head columns a register pass)
    ff = 64
    x = torch.zeros(2, T_, d, dtype=torch.bfloat16)
    ws = tuple(torch.zeros(s, dtype=torch.bfloat16 if i < 8 else
                           torch.float32)
               for i, s in enumerate(((d, 3 * d), (3 * d,), (d, d), (d,),
                                      (d, ff), (ff,), (ff, d), (d,), (d,),
                                      (d,), (d,), (d,))))
    assert ET._check(x, ws, nh, 2)[:4] == (2, T_, d, ff)
    lay = ET.bf16_scratch_layout(2, T_, d, ff, True)
    assert lay.arrays["qkv"][2] == (2 * T_, 3 * d)
