"""The FK plan that kernels K3 (tail_fused) and K6 (fk_bullet_fused) walk
(tip_tpu_torch/ops/kinematics.py: fk_plan, fk_plan_table), on the CPU.

A plain PyTorch walk along the plan, link by link from the root down as a
lane of the kernels composes its link's chain, equals the port's plain FK
(fk_bullet_fused_plain) and tip_tpu's: float64 to 1e-12 against tip_tpu's
fk_bullet_state, float32 to 1e-5 against tip_tpu's fused FK kernel (the
Pallas kernel in interpret mode, as tests/test_torch_kernels_plain.py runs
it) where that kernel can walk the skeleton (chains of 11 and 19 joints
included), against fk_bullet_state where it cannot (children listed before
their parents). The float32 walk reads
the packed table the kernels read. Then the plan's limits, and the tail
wrappers' per-skeleton cache of launch arguments (host only).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.ops import kinematics as jkin
from tip_tpu_torch.ops import fused_tail as TFT
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.ops import rotations as rot

torch.set_num_threads(1)

AMASS = jkin.amass_skeleton()
# joint 1 (lknee) and joint 10 (upperneck) fixed besides the wrists
FIXED = tuple(bool(f) or j in (1, 10) for j, f in enumerate(AMASS.is_fixed))
# the left leg reversed: lankle (2) hangs off the root, lknee (1) off it,
# lhip (0) off lknee, so joints 0 and 1 come before their parents
CHILDREN_FIRST = (1, 2, -1) + tuple(AMASS.parent[3:])
# and the left arm reversed through the fixed lwrist (14): lwrist hangs off
# the chest, lelbow (13) off it, lshoulder (12) off lelbow, lclavicle (11)
# off lshoulder; the pose layout stays, so K3 and K6 take it
# (chip_smoke.py runs them on it)
CHILDREN_FIRST_FIXED = CHILDREN_FIRST[:11] + (12, 13, 14, 8) \
    + tuple(AMASS.parent[15:])
# the right arm hung off the left wrist: rclavicle (15) off lwrist (14), a
# chain of 11 joints, parent first (chip_smoke.py runs K3 and K6 on it)
DEEP_11 = AMASS.parent[:15] + (14,) + AMASS.parent[16:]
# every joint off the one before it: a chain of 19
LINE_19 = (-1,) + tuple(range(18))
SKELETONS = {"amass": (AMASS.parent, AMASS.is_fixed),
             "fixed_joints": (AMASS.parent, FIXED),
             "children_first": (CHILDREN_FIRST, AMASS.is_fixed),
             "children_first_fixed": (CHILDREN_FIRST_FIXED, AMASS.is_fixed),
             "deep_11": (DEEP_11, AMASS.is_fixed),
             "line_19": (LINE_19, AMASS.is_fixed)}


def skeletons(name, dtype):
    parent, fixed = SKELETONS[name]
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    j = jkin.Skeleton(parent=tuple(parent), is_fixed=tuple(fixed),
                      joint_offset=jnp.asarray(AMASS.joint_offset, jd),
                      com_offset=jnp.asarray(AMASS.com_offset, jd),
                      link_mass=jnp.asarray(AMASS.link_mass, jd))
    t = tkin.make_skeleton(parent, fixed, np.array(AMASS.joint_offset),
                           np.array(AMASS.com_offset),
                           np.array(AMASS.link_mass),
                           dtype=torch.from_numpy(np.zeros(0, dtype)).dtype)
    return j, t


def links_from_plan(skel, slot):
    """Per link: (CoM offset, [(joint offset, quat index), ...] from the
    root down), from fk_plan and the skeleton's own offsets."""
    return [(skel.com_offset[link],
             [(skel.joint_offset[j], -1 if skel.is_fixed[j] else 1 + slot[j])
              for j in chain])
            for link, chain in enumerate(tkin.fk_plan(skel.parent))]


def links_from_table(tab, n_links):
    """The same read from the packed table, as a lane of K3/K6 reads its
    column: depth from row 0's int bits, then rows 1..depth."""
    bits = tab.view(np.int32)
    out = []
    for link in range(n_links):
        depth = bits[0, link, 3]
        out.append((torch.from_numpy(tab[0, link, :3].copy()),
                    [(torch.from_numpy(tab[k, link, :3].copy()),
                      int(bits[k, link, 3])) for k in range(1, depth + 1)]))
    return out


def plan_walk(links, pose):
    """Lane l of the kernels: the pose's 18 quats decoded, then link l's
    chain composed from the root down (the offset rotated and added, the
    joint's rotation composed unless the joint is fixed), then its CoM."""
    qn = rot.aa_to_q(pose[3:57].reshape(18, 3))
    com, jf = [], []
    for coff, steps in links:
        p, q = pose[:3], qn[0]
        for off, qi in steps:
            p = p + rot.q_rotate(q, off.to(pose.dtype))
            if qi >= 0:
                q = rot.q_mult(q, qn[qi])
        com.append(torch.cat([p + rot.q_rotate(q, coff.to(pose.dtype)), q]))
        jf.append(torch.cat([p, q]))
    return torch.stack(com), torch.stack(jf)


@pytest.mark.parametrize("name", sorted(SKELETONS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plan_walk_matches_plain_fk_and_tip_tpu(name, dtype):
    jskel, tskel = skeletons(name, dtype)
    L = tskel.n_joints + 1
    if dtype == np.float64:
        links = links_from_plan(tskel, tkin._ACTIVE_SLOT)
        tol = 1e-12
    else:
        links = links_from_table(
            tkin.fk_plan_table(tskel, tkin._ACTIVE_SLOT), L)
        tol = 1e-5
    rng = np.random.default_rng(7)
    for _ in range(3):
        pose = (rng.normal(size=57) * 0.4).astype(dtype)
        com, jf = plan_walk(links, torch.as_tensor(pose))
        p_com, p_jf = tkin.fk_bullet_fused_plain(tskel, torch.as_tensor(pose))
        if dtype == np.float32 and not name.startswith("children_first"):
            j_com, j_jf = jkin.fk_bullet_fused(jskel, jnp.asarray(pose),
                                               interpret=True)
        else:
            j_com, j_jf = jkin.fk_bullet_state(jskel, jnp.asarray(pose), True)
        for a, b, what in ((com, p_com, "pq_com plain"),
                           (jf, p_jf, "pq_jf plain"),
                           (com, j_com, "pq_com tip_tpu"),
                           (jf, j_jf, "pq_jf tip_tpu")):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=tol, err_msg=what)


def test_plan_table_layout():
    """Row 0: CoM offset, depth; rows 1..depth: the chain's joint
    offsets and quat indices (-1 fixed); zero elsewhere."""
    sk = tkin.amass_skeleton()
    tab = tkin.fk_plan_table(sk, TFT._JOINT_SLOT)
    bits = tab.view(np.int32)
    assert tab.shape == (tkin.K_PLAN_ROWS, tkin.K_MAX_LINKS, 4)
    depth = bits[0, :, 3]
    assert depth.max() == 7 and depth[0] == 0
    assert list(depth[:20]) == [len(c) for c in tkin.fk_plan(sk.parent)]
    assert (tab[:, 20:] == 0).all()
    wrist = 15                                # link of joint 14, fixed
    assert bits[depth[wrist], wrist, 3] == -1
    np.testing.assert_array_equal(tab[depth[wrist], wrist, :3],
                                  sk.joint_offset[14].numpy())
    for link in range(20):
        assert (tab[depth[link] + 1:, link] == 0).all()


@pytest.mark.parametrize("parent, match", [
    ((1, 0), "cycle"),                                  # 0 and 1 each other's
    ((-1, 0, 5), "cycle or dangling"),                  # no joint 5
    ((-1,) + tuple(range(31)), "at most 32"),           # 33 links
])
def test_plan_raises(parent, match):
    with pytest.raises(ValueError, match=match):
        tkin.fk_plan(parent)


def test_pose_skeleton_deeper_than_the_plan_is_refused():
    """Chains deeper than a pass of the kernels' walk (K_MAX_DEPTH joints)
    were refused once; now they are taken: the right arm hung off the left
    wrist (a chain of 11 joints) and a line of all 19 joints. The tail's
    and the FK's plain versions equal tip_tpu's fused FK kernel there (in
    interpret mode, float32), and the FK plan holds every joint of the
    deepest chain. Children listed first are taken too, a fixed joint
    inside a chain as well."""
    rng = np.random.default_rng(3)
    for name, depth in (("deep_11", 11), ("line_19", 19)):
        jskel, tskel = skeletons(name, np.float32)
        tkin.check_pose_skeleton(tskel, "tail_fused")
        tab = tkin.fk_plan_table(tskel, TFT._JOINT_SLOT)
        assert tab.view(np.int32)[0, :, 3].max() == depth
        for args in (TFT._tail_args, tkin._fk_args):
            assert args(tskel, torch.device("cpu"), ()).deep
        s = torch.as_tensor((rng.normal(size=114) * 0.4).astype(np.float32))
        pose = tkin.our_pose_to_bullet(s)
        j_com, j_jf = jkin.fk_bullet_fused(jskel, jnp.asarray(pose.numpy()),
                                           interpret=True)
        prev = tkin.fk_our_state(tskel, s)
        tail = TFT.tail_fused_plain(tskel, s, torch.zeros(20), prev)
        fk = tkin.fk_bullet_fused_plain(tskel, pose)
        for a, b, what in ((tail.pq_com, j_com, "tail pq_com"),
                           (tail.pq_jf, j_jf, "tail pq_jf"),
                           (fk[0], j_com, "fk pq_com"),
                           (fk[1], j_jf, "fk pq_jf")):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5, err_msg=f"{name} {what}")
    for name in ("children_first", "children_first_fixed"):
        _, first = skeletons(name, np.float32)
        tkin.check_pose_skeleton(first, "tail_fused")


def _tail(sk, lead, coeff):
    return TFT._tail_args(sk, torch.device("cpu"), lead)


def _fk(sk, lead, coeff):
    return tkin._fk_args(sk, torch.device("cpu"), lead)


def _decode(sk, lead, coeff):
    return TFT._decode_args(coeff, torch.device("cpu"), lead + (131,), 6, 5)


@pytest.mark.parametrize("args", [_tail, _fk, _decode])
def test_wrapper_cache_rebuilt_when_skeleton_or_batch_changes(args):
    """The launch arguments a wrapper checks and packs once: the same
    object for the same skeleton (K2: the same coeff), device and leading
    shape; a new one when the skeleton, its coeff or B changes, or when an
    offset tensor the plan copied is written."""
    sk = tkin.amass_skeleton()
    coeff = torch.tensor(0.6 ** np.arange(6)[::-1], dtype=torch.float32)
    one = args(sk, (), coeff)
    assert args(sk, (), coeff) is one and not one.deep
    pool = args(sk, (64,), coeff)
    assert pool is not one and pool.B == 64 and one.B == 1
    assert pool.shapes[0][0] == 64 and pool.n_out == 64 * one.n_out
    assert [v[0][1:] for v in pool.views] == [v[0] for v in one.views]
    other = args(tkin.amass_skeleton(scale=1.1), (), coeff.clone())
    assert other is not one
    if args is _decode:
        assert other.table is not coeff
        return
    assert not torch.equal(other.table, one.table)
    # a skeleton made from another has its own entry
    moved = dataclasses.replace(sk, joint_offset=sk.joint_offset * 2)
    assert not torch.equal(args(moved, (), coeff).table, one.table)
    slot = TFT._JOINT_SLOT if args is _tail else tkin._ACTIVE_SLOT
    np.testing.assert_array_equal(one.table.numpy(),
                                  tkin.fk_plan_table(sk, slot))
    # an offset written in place: the plan is made again from it
    written = dataclasses.replace(sk, com_offset=sk.com_offset.clone())
    before = args(written, (), coeff)
    written.com_offset.mul_(2)
    after = args(written, (), coeff)
    assert after is not before and args(written, (), coeff) is after
    np.testing.assert_array_equal(after.table.numpy(),
                                  tkin.fk_plan_table(written, slot))
    assert not torch.equal(after.table, before.table)
