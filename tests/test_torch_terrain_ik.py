"""The port's two-joint IK (tip_tpu_torch/ops/ik.py) and terrain estimation
(tip_tpu_torch/runtime/terrain.py) against tip_tpu's, on the CPU in
float64, seeded with numpy.

The IK on chains from FK of random poses of the AMASS skeleton (legs and
arms; a zero delta and a target out of reach included) equals tip_tpu's to
1e-10. A seeded sequence of terrain observations gives the same region map
and region count exactly, and heights, weights and confidence to 1e-10:
patches clamped at each edge of the grid, steps that update nothing, and a
region table filled past ``max_regions``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.chars.amass import IK_CHAIN_BULLET as J_CHAIN
from tip_tpu.chars.amass import IK_CHAIN_NIMBLE as J_NIMBLE
from tip_tpu.chars.amass import SBP_LINKS as J_SBP_LINKS
from tip_tpu import constants as jcst
from tip_tpu.ops import ik as jik
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import terrain as jter
from tip_tpu_torch import constants as tcst
from tip_tpu_torch.chars import amass as tchar
from tip_tpu_torch.ops import ik as tik
from tip_tpu_torch.runtime import terrain as tter

torch.set_num_threads(1)

TOL = 1e-10


def test_copied_tables_match_tip_tpu():
    assert tchar.SBP_LINKS == tuple(J_SBP_LINKS)
    assert tchar.IK_CHAIN_BULLET == J_CHAIN
    assert tchar.IK_CHAIN_NIMBLE == J_NIMBLE
    for name in ("MAP_BOUND", "GRID_SIZE", "GRID_NUM"):
        assert getattr(tcst, name) == getattr(jcst, name)


def chains(limb, n=6, seed=0):
    """(n, 4, 7) joint frames of the (parent, a, b, c) links of ``limb``
    from FK of seeded random bullet poses (float64)."""
    rng = np.random.default_rng(seed)
    skel = jkin.amass_skeleton(dtype=jnp.float64)
    rows = np.array(J_CHAIN[limb]) + 1
    out = []
    for _ in range(n):
        pose = rng.normal(size=57) * 0.4
        pose[2] += 0.9
        _, pq_jf = jkin.fk_bullet_state(skel, jnp.asarray(pose), True)
        out.append(np.asarray(pq_jf)[rows])
    return np.stack(out)


def deltas(n, seed):
    """n target moves: random ones, a zero one and one out of reach."""
    d = np.random.default_rng(seed).normal(size=(n, 3)) * 0.05
    d[0] = 0.0
    d[1] = [2.0, -1.5, 1.0]
    return d


@pytest.mark.parametrize("limb,is_arm", [("lankle", False),
                                         ("rankle", False),
                                         ("lwrist", True), ("rwrist", True)])
def test_two_joint_ik_matches_tip_tpu(limb, is_arm):
    q = chains(limb, seed=1 + is_arm)
    d = deltas(len(q), seed=3)
    # the port's runs the whole batch in one call; tip_tpu's one chain
    t_out = tik.two_joint_ik(*(torch.from_numpy(q[:, i]) for i in range(4)),
                             torch.from_numpy(d), is_arm=is_arm)
    for n in range(len(q)):
        j_out = jik.two_joint_ik(*(jnp.asarray(q[n, i]) for i in range(4)),
                                 jnp.asarray(d[n]), is_arm=is_arm)
        for a, b in zip(t_out, j_out):
            np.testing.assert_allclose(a[n].numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("limb", ["lankle", "rankle"])
def test_leg_two_joint_ik_keep_foot_matches_tip_tpu(limb):
    q = chains(limb, seed=4)
    d = deltas(len(q), seed=5)
    t_out = tik.leg_two_joint_ik_keep_foot(
        *(torch.from_numpy(q[:, i]) for i in range(4)), torch.from_numpy(d))
    for n in range(len(q)):
        j_out = jik.leg_two_joint_ik_keep_foot(
            *(jnp.asarray(q[n, i]) for i in range(4)), jnp.asarray(d[n]))
        for a, b in zip(t_out, j_out):
            np.testing.assert_allclose(a[n].numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)


def observations(cfg, n, seed):
    """A seeded sequence of (c_loc, do_update): contacts on a few height
    levels near 0 and above it, patches against each grid edge and corner,
    and steps that update nothing."""
    rng = np.random.default_rng(seed)
    B = cfg.map_bound
    edges = [(-B, 0.3), (B - 0.01, -0.2), (0.4, -B), (-0.1, B), (B, B),
             (-B - 0.5, -B - 0.5)]
    out = []
    for i in range(n):
        if i < len(edges) * 2 and i % 2 == 0:
            xy = np.array(edges[i // 2])
        else:
            xy = rng.uniform(-B, B, size=2)
        h = rng.choice([0.0, 0.02, 0.3, 0.33, 0.6, 0.9, 1.2]) \
            + rng.normal() * 0.02
        out.append((np.array([xy[0], xy[1], h]), bool(rng.random() < 0.8)))
    return out


def run_both(cfg, obs):
    """Both update_height_map's over the observations; returns the final
    states (as numpy dicts) and the corrections of every step."""
    js = jter.terrain_init(cfg, jnp.float64)
    ts = tter.terrain_init(cfg, torch.float64, device="cpu")
    jc, tc = [], []
    for c_loc, do in obs:
        js, j_corr = jter.update_height_map(js, cfg, jnp.asarray(c_loc),
                                            jnp.asarray(do))
        ts, t_corr = tter.update_height_map(ts, cfg, torch.from_numpy(c_loc),
                                            torch.tensor(do))
        jc.append(float(j_corr))
        tc.append(t_corr.item())
    names = ("region_map", "confidence", "region_height", "region_weight",
             "n_regions")
    return ({n: np.asarray(getattr(js, n)) for n in names},
            {n: getattr(ts, n).numpy() for n in names}, jc, tc)


@pytest.mark.parametrize("max_regions,n", [(64, 120), (6, 80)])
def test_update_height_map_matches_tip_tpu(max_regions, n):
    """max_regions 6: the table fills and its last slot is reused."""
    cfg = jter.TerrainConfig(map_bound=2.0, max_regions=max_regions)
    tcfg = tter.TerrainConfig(map_bound=2.0, max_regions=max_regions)
    assert tcfg.grid_num == cfg.grid_num == 40
    assert tcfg.diffuse_region == cfg.diffuse_region == 5
    obs = observations(cfg, n, seed=max_regions)
    j, t, jc, tc = run_both(cfg, obs)
    np.testing.assert_array_equal(t["region_map"], j["region_map"])
    assert int(t["n_regions"]) == int(j["n_regions"])
    for name in ("confidence", "region_height", "region_weight"):
        np.testing.assert_allclose(t[name], j[name], rtol=0, atol=TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=TOL)
    # the sequence exercises what it is meant to
    assert int(t["n_regions"]) >= 4
    if max_regions == 6:
        assert int(t["n_regions"]) == max_regions
    established = t["confidence"] > -99
    for edge in (established[0], established[-1], established[:, 0],
                 established[:, -1]):
        assert edge.any()
    assert not all(do for _, do in obs)


def test_update_height_map_no_update_is_a_no_op():
    cfg = tter.TerrainConfig(map_bound=2.0)
    s0 = tter.terrain_init(cfg, torch.float64, device="cpu")
    s1, _ = tter.update_height_map(s0, cfg, torch.tensor([0.3, 0.2, 0.5],
                                                         dtype=torch.float64),
                                   torch.tensor(True))
    s2, corr = tter.update_height_map(s1, cfg, torch.tensor(
        [0.1, -0.4, 0.9], dtype=torch.float64), torch.tensor(False))
    assert corr.item() == 0.0
    for name in ("region_map", "confidence", "region_height",
                 "region_weight", "n_regions"):
        assert torch.equal(getattr(s2, name), getattr(s1, name)), name
    np.testing.assert_array_equal(tter.height_field(s2).numpy(),
                                  s2.region_height[s2.region_map].numpy())
