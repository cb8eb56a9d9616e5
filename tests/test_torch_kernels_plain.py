"""The plain PyTorch versions of the port's kernels against tip_tpu's Pallas
kernels (run in interpret mode, as tip_tpu's own tests run them).

K1 fused_rnn_plain, K2 decode_fused_plain, K3 tail_fused_plain and K6
fk_bullet_fused_plain (K4/K5: tests/test_torch_fused_forward.py) are what
the wrappers run for CPU tensors and what chip_smoke.py holds the CUDA
kernels against on the card. In float64 they agree with the Pallas kernels
to 1e-12 (1e-10 for the residues, which divide by dt = 1/60); float32 uses
tip_tpu's own tolerances (tests/test_fused_tail.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from tip_tpu.ops import fused_tail as JFT
from tip_tpu.ops import kinematics as jkin
from tip_tpu.ops import pallas_kernels as PK
from tip_tpu_torch.ops import fused_rnn as TFR
from tip_tpu_torch.ops import fused_tail as TFT
from tip_tpu_torch.ops import kinematics as tkin

torch.set_num_threads(1)

F64 = dict(dtype=np.float64, tol=1e-12, tol_res=1e-10)
# float32: tip_tpu's tolerances for its kernel vs the XLA ops
F32 = dict(dtype=np.float32, tol=2e-6, tol_res=1e-4)
DTYPES = {"f64": F64, "f32": F32}


def _close(t, j, atol, name=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0,
                               err_msg=name)


def test_fused_rnn_plain_matches_pallas():
    rng = np.random.default_rng(0)
    xin = rng.normal(size=(2, 40, 64))
    w = rng.uniform(-1, 1, size=(64, 64)) / 8.0
    j = PK.fused_rnn(jnp.asarray(xin), jnp.asarray(w), interpret=True)
    t = TFR.fused_rnn_plain(torch.as_tensor(xin), torch.as_tensor(w))
    _close(t, j, 1e-12)
    # the wrapper runs the plain version for a CPU tensor
    t_auto = TFR.fused_rnn(torch.as_tensor(xin), torch.as_tensor(w))
    np.testing.assert_array_equal(t_auto.numpy(), t.numpy())


@pytest.mark.parametrize("B", [1, 3, 8, 17, 64, 256, 1000])
def test_fused_rnn_plan_fits_and_covers_every_row(B):
    """K1's launch plan at the model's H 512: W_hh's slice and two h
    buffers fit in a block's shared memory, the clusters' tiles cover every
    batch row once, and B 256 fills at most the H100's 132 SMs."""
    plan = TFR.fused_rnn_plan(B, 512)
    assert plan.smem_bytes <= 232448
    assert plan.cluster * plan.cols == 512
    tiles = [range(i * plan.batch_tile, min(B, (i + 1) * plan.batch_tile))
             for i in range(plan.clusters)]
    assert [r for rows in tiles for r in rows] == list(range(B))
    assert all(len(rows) > 0 for rows in tiles)
    if B <= 256:
        assert plan.cluster * plan.clusters <= 132
    if B == 1:
        assert plan.clusters == 1


@pytest.mark.parametrize("H", [1024, 2048, 24, 100])
def test_fused_rnn_plan_raises_where_the_slice_cannot_fit(H):
    """H 1024 and 2048 raise (W's f32 slice alone is past a block's shared
    memory), naming the bytes; H 24 and 100 plan (one and four blocks of
    32 columns, the others' columns zero)."""
    if H in (24, 100):
        plan = TFR.fused_rnn_plan(1, H)
        assert plan.cols == 32 and plan.cluster * plan.cols >= H
        assert plan.smem_bytes == TFR.walk_smem_bytes(H, 32, 1)
        return
    with pytest.raises(ValueError, match="fused_rnn") as e:
        TFR.fused_rnn_plan(1, H)
    assert f"{TFR.MAX_SMEM} a block" in str(e.value)


def _decode_inputs(rng, dtype):
    D, nf = 131, 6
    y_t = rng.normal(size=D).astype(dtype)
    filt = rng.normal(size=(nf, D)).astype(dtype)
    coeff = (0.6 ** np.arange(nf)[::-1]).astype(dtype)
    m9 = Rotation.from_rotvec(rng.normal(size=3)).as_matrix() \
        .reshape(9).astype(dtype)
    return y_t, filt, coeff, m9


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("use_filter", [False, True])
def test_decode_fused_plain_matches_pallas(dt_name, use_filter):
    d = DTYPES[dt_name]
    rng = np.random.default_rng(11)
    for _ in range(3):
        y_t, filt, coeff, m9 = _decode_inputs(rng, d["dtype"])
        j = JFT.decode_fused(jnp.asarray(y_t), jnp.asarray(filt),
                             jnp.asarray(coeff), use_filter, jnp.asarray(m9),
                             interpret=True)
        t = TFT.decode_fused(*(torch.as_tensor(a) for a in (y_t, filt, coeff)),
                             use_filter, torch.as_tensor(m9))
        assert t.c_t[:, 0].min() == 0 and t.c_t[:, 0].max() == 1
        for f in TFT.DecodeOut._fields:
            _close(getattr(t, f), getattr(j, f), d["tol"], f)


def _tail_inputs(rng, dtype, jskel):
    s = rng.normal(size=114) * 0.4
    s[2] += 0.9
    ct = rng.normal(size=(5, 4))
    ct[:, 0] = (ct[:, 0] > 0)                 # decoded flags, random
    ct[:, 1:] *= 0.05
    prev_s = s + rng.normal(size=114) * 0.01
    prev_pq = np.asarray(jkin.fk_our_state(jskel, jnp.asarray(prev_s)))
    return (s.astype(dtype), ct.reshape(-1).astype(dtype),
            prev_pq.astype(dtype))


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("seed", [3, 4])
def test_tail_fused_plain_matches_pallas(dt_name, seed):
    d = DTYPES[dt_name]
    dtype = d["dtype"]
    rng = np.random.default_rng(seed)
    jskel = jkin.amass_skeleton(dtype=dtype)
    tskel = tkin.amass_skeleton(dtype=torch.float64 if dtype == np.float64
                                else torch.float32)
    for _ in range(3):
        s, ct, prev_pq = _tail_inputs(rng, dtype, jskel)
        j = JFT.tail_fused(jskel, jnp.asarray(s), jnp.asarray(ct),
                           jnp.asarray(prev_pq), interpret=True)
        t = TFT.tail_fused(tskel, *(torch.as_tensor(a)
                                    for a in (s, ct, prev_pq)))
        for f in TFT.TailOut._fields:
            tol = d["tol_res"] if f in ("raw_res", "vel_res") else d["tol"]
            if dtype == np.float32 and f in ("c_locs",):
                tol = 2e-5                   # tip_tpu's own c_locs tolerance
            np.testing.assert_array_equal(
                np.isnan(getattr(t, f).numpy()),
                np.isnan(np.asarray(getattr(j, f))), err_msg=f)
            _close(getattr(t, f), getattr(j, f), tol, f)


@pytest.mark.parametrize("i", range(5))
def test_fk_bullet_fused_plain_matches_pallas(i):
    """K6's plain version against tip_tpu's fused FK kernel, five poses at
    tip_tpu's own tolerance (tests/test_kinematics.py)."""
    rng = np.random.default_rng(i)
    state = rng.normal(size=57).astype(np.float32) * 0.4
    j_com, j_jf = jkin.fk_bullet_fused(jkin.amass_skeleton(),
                                       jnp.asarray(state), interpret=True)
    tskel = tkin.amass_skeleton()
    t_com, t_jf = tkin.fk_bullet_fused(tskel, torch.as_tensor(state))
    assert t_com.shape == t_jf.shape == (20, 7)
    _close(t_com, j_com, 2e-6, "pq_com")
    _close(t_jf, j_jf, 2e-6, "pq_jf")
    # the fixed wrists inherit the elbows' orientation
    np.testing.assert_array_equal(t_jf[15, 3:].numpy(), t_jf[14, 3:].numpy())
    p_com, p_jf = tkin.fk_bullet_fused_plain(tskel, torch.as_tensor(state))
    assert torch.equal(p_com, t_com) and torch.equal(p_jf, t_jf)


def test_fk_bullet_fused_f64_matches_tip_tpu():
    state = np.random.default_rng(9).normal(size=57) * 0.4
    j_com, j_jf = jkin.fk_bullet_state(jkin.amass_skeleton(dtype=np.float64),
                                       jnp.asarray(state), True)
    t_com, t_jf = tkin.fk_bullet_fused_plain(
        tkin.amass_skeleton(dtype=torch.float64), torch.as_tensor(state))
    _close(t_com, j_com, 1e-12)
    _close(t_jf, j_jf, 1e-12)


def test_pose_skeleton_check():
    """K3 and K6 walk the 19-joint pose layout along the skeleton's FK
    plan; a skeleton with a cycle or another layout is refused before any
    launch (tests/test_torch_fk_plan.py: the plan itself)."""
    skel = tkin.amass_skeleton()
    tkin.check_pose_skeleton(skel, "fk")
    parent = list(skel.parent)
    parent[1] = 2                  # joints 1 and 2 each other's parent
    bad = tkin.make_skeleton(parent, skel.is_fixed, skel.joint_offset,
                             skel.com_offset, skel.link_mass)
    with pytest.raises(ValueError, match="parent"):
        tkin.check_pose_skeleton(bad, "fk")
    short = tkin.make_skeleton(skel.parent[:3], skel.is_fixed[:3],
                               skel.joint_offset[:3], skel.com_offset[:4],
                               skel.link_mass[:4])
    with pytest.raises(ValueError, match="19-joint"):
        tkin.check_pose_skeleton(short, "fk")
    fixed = list(skel.is_fixed)
    fixed[0] = True                             # another joint fixed
    other = tkin.make_skeleton(skel.parent, fixed, skel.joint_offset,
                               skel.com_offset, skel.link_mass)
    with pytest.raises(ValueError, match="19-joint"):
        tkin.check_pose_skeleton(other, "fk")


def test_wrappers_raise_for_explicit_kernel_on_cpu():
    """A kernel asked for by name on CPU tensors raises; nothing falls back
    silently."""
    xin, w = torch.zeros(1, 4, 8), torch.zeros(8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        TFR.fused_rnn(xin, w, impl="kernel")
    y_t, filt, coeff, m9 = (torch.as_tensor(a) for a in
                            _decode_inputs(np.random.default_rng(0),
                                           np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        TFT.decode_fused(y_t, filt, coeff, True, m9, impl="fused")
    skel = tkin.amass_skeleton()
    with pytest.raises(ValueError, match="CUDA"):
        TFT.tail_fused(skel, torch.zeros(114), torch.zeros(20),
                       torch.zeros(20, 7), impl="fused")
    with pytest.raises(ValueError, match="CUDA"):
        tkin.fk_bullet_fused(skel, torch.zeros(57), impl="kernel")
    with pytest.raises(ValueError):
        TFR.fused_rnn(xin, w, impl="pallas")
    with pytest.raises(ValueError):
        tkin.fk_bullet_fused(skel, torch.zeros(57), impl="pallas")


# ---------------------------------------------------------------------------
# a pool of B streams: one call with a leading stream axis equals B calls
# ---------------------------------------------------------------------------

def _pool_inputs(rng, B, dtype):
    dec = [_decode_inputs(rng, dtype) for _ in range(B)]
    y_t, filt, m9 = (np.stack([d[i] for d in dec]) for i in (0, 1, 3))
    s = (rng.normal(size=(B, 114)) * 0.4).astype(dtype)
    s[:, 2] += 0.9
    ct = rng.normal(size=(B, 5, 4)).astype(dtype)
    ct[..., 0] = ct[..., 0] > 0
    ct[..., 1:] *= 0.05
    return y_t, filt, dec[0][2], m9, s, ct.reshape(B, 20)


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("kernel", ["decode_fused", "tail_fused",
                                    "fk_bullet_fused"])
def test_batched_plain_versions_equal_unbatched_calls(kernel, dt_name):
    """K2, K3 and K6 serve a pool tick with one call: the plain versions
    with a leading stream axis give exactly what B single-stream calls give
    (per-stream filter flags for K2)."""
    dtype = DTYPES[dt_name]["dtype"]
    B = 5
    y_t, filt, coeff, m9, s, ct = (
        torch.as_tensor(a) for a in _pool_inputs(np.random.default_rng(7), B,
                                                 dtype))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    skel = tkin.amass_skeleton(dtype=tdt)

    def same(a, b):
        return torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))

    if kernel == "decode_fused":
        flags = torch.tensor([True, False, True, True, False])
        out = TFT.decode_fused(y_t, filt, coeff, flags, m9)
        assert out.q_rows.shape == (B, 18, 4) and out.c_t.shape == (B, 5, 4)
        for b in range(B):
            one = TFT.decode_fused(y_t[b], filt[b], coeff, bool(flags[b]),
                                   m9[b])
            assert all(same(getattr(out, f)[b], getattr(one, f))
                       for f in out._fields)
        # one host flag for every stream
        every = TFT.decode_fused(y_t, filt, coeff, True, m9)
        assert same(every.y_f[1], TFT.decode_fused(y_t[1], filt[1], coeff,
                                                   True, m9[1]).y_f)
    elif kernel == "tail_fused":
        prev = tkin.fk_our_state(skel, s + 0.01)
        out = TFT.tail_fused(skel, s, ct, prev)
        assert out.pq_com.shape == (B, 20, 7) and out.vel_res.shape == (B, 3)
        assert torch.isnan(out.raw_res).any() and (out.active > 0).any()
        for b in range(B):
            one = TFT.tail_fused(skel, s[b], ct[b], prev[b])
            assert all(same(getattr(out, f)[b], getattr(one, f))
                       for f in out._fields)
    else:
        pose = tkin.our_pose_to_bullet(s)
        out = tkin.fk_bullet_fused(skel, pose)
        assert out[0].shape == (B, 20, 7)
        for b in range(B):
            one = tkin.fk_bullet_fused(skel, pose[b])
            assert same(out[0][b], one[0]) and same(out[1][b], one[1])
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "fk_bullet_fused":
            tkin.fk_bullet_fused(skel, tkin.our_pose_to_bullet(s),
                                 impl="kernel")
        elif kernel == "tail_fused":
            TFT.tail_fused(skel, s, ct, tkin.fk_our_state(skel, s),
                           impl="fused")
        else:
            TFT.decode_fused(y_t, filt, coeff, True, m9, impl="fused")
