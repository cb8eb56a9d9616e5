"""Terrain estimation: height-region clustering over a 2-D grid (twin of
tip_tpu/runtime/terrain.py).

SBP contact heights are clustered into height regions; a region-id map and
a confidence map over a fixed grid record which region owns each cell; the
root-height correction comes from the region height under the contact
point. The reference's documented divergences are kept: the region table
has a fixed capacity (when full, the last slot is reused), update patches
are clamped to the grid, and "a nearby region of similar height" scans every
cell of the patch (the first minimum wins).

Everything stays on the device: the patch's clamped corner is a device
tensor and the patch is gathered and written back through index tensors,
so an update reads nothing back to the host.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch import device_const, resolve_device


@dataclass(frozen=True)
class TerrainConfig:
    map_bound: float = cst.MAP_BOUND      # grid covers [-bound, bound] m
    grid_size: float = cst.GRID_SIZE
    max_regions: int = 64
    establish_ticks: int = 50             # establishing phase length
    temporal_inertia: float = 1.0
    height_correction_force: float = 20.0
    pelvis_terrain_thres: float = 0.2
    update_epsilon: float = 0.1
    diffuse_m: float = 0.5                # patch half-size in meters

    @property
    def grid_num(self) -> int:
        return int(self.map_bound / self.grid_size) * 2

    @property
    def diffuse_region(self) -> int:
        return round(self.diffuse_m / self.grid_size)


@dataclass
class TerrainState:
    region_map: torch.Tensor       # (G, G) int64 region id per cell
    confidence: torch.Tensor       # (G, G)
    region_height: torch.Tensor    # (R,)
    region_weight: torch.Tensor    # (R,)
    n_regions: torch.Tensor        # () int64 allocation cursor


def terrain_init(cfg: TerrainConfig, dtype=torch.float32,
                 device=None) -> TerrainState:
    """The empty map on ``device`` (``cuda`` unless the caller asks for
    another): every cell region 0 (the ground, z = 0) at confidence
    -100."""
    device = resolve_device(device)
    G, R = cfg.grid_num, cfg.max_regions
    weight = torch.zeros((R,), dtype=dtype, device=device)
    weight[0] = 10.0
    return TerrainState(
        region_map=torch.zeros((G, G), dtype=torch.int64, device=device),
        confidence=torch.full((G, G), -100.0, dtype=dtype, device=device),
        region_height=torch.zeros((R,), dtype=dtype, device=device),
        region_weight=weight,
        n_regions=torch.ones((), dtype=torch.int64, device=device),
    )


def _diffuse_confidence(cfg: TerrainConfig, dtype, device) -> torch.Tensor:
    """Radial cost map of a patch, used only for ranking."""
    d = cfg.diffuse_region
    x = np.arange(-d, d)
    xx, yy = np.meshgrid(x, x)
    conf = -np.sqrt(xx ** 2 + yy ** 2)
    return device_const(tuple(map(tuple, conf.tolist())), dtype, device)


def _one(t: torch.Tensor) -> torch.Tensor:
    """A () index tensor as a (1,) one, for indexing without a read-back."""
    return t.reshape(1)


def update_height_map(state: TerrainState, cfg: TerrainConfig, c_loc,
                      do_update) -> Tuple[TerrainState, torch.Tensor]:
    """One SBP height observation (the reference's update_height_map_new,
    minus the tick bookkeeping, which lives in the full runner's carry).

    Args:
      c_loc: (3,) the previous frame's SBP world location.
      do_update: () bool tensor — contact active and establishing tick == 0.

    Returns (new_state, height_correction): the correction is the height of
    the region under the contact minus the contact height (0 when nothing
    was updated).
    """
    G = cfg.grid_num
    d = cfg.diffuse_region
    dtype = state.confidence.dtype
    dev = state.confidence.device
    c_loc = torch.as_tensor(c_loc, dtype=dtype, device=dev)

    h = c_loc[2]
    # torch.round, as jnp.round, rounds half to even
    ci = torch.round(c_loc[0] / cfg.grid_size).to(torch.int64) + G // 2
    cj = torch.round(c_loc[1] / cfg.grid_size).to(torch.int64) + G // 2
    # the patch's corner clamped into the grid, its cells by index tensors
    patch = device_const(tuple(range(2 * d)), torch.int64, dev)
    rows = (torch.clamp(ci - d, 0, G - 2 * d) + patch)[:, None]
    cols = (torch.clamp(cj - d, 0, G - 2 * d) + patch)[None, :]
    region_old = state.region_map[rows, cols]
    conf_old = state.confidence[rows, cols]

    # --- choose region: nearby cell with similar height, else allocate ------
    patch_heights = state.region_height[region_old]
    diffs = torch.abs(patch_heights - h).reshape(-1)
    flat_idx = _one(torch.argmin(diffs))       # the first minimum, as jnp's
    best_region = region_old.reshape(-1)[flat_idx][0]
    min_diff = diffs[flat_idx][0]

    is_ground = h < state.region_height[0] + cfg.update_epsilon
    found = min_diff < cfg.update_epsilon
    # a full table reuses its last slot
    new_idx = torch.clamp(state.n_regions, max=cfg.max_regions - 1)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    region_id = torch.where(is_ground, zero,
                            torch.where(found, best_region, new_idx))
    allocate = do_update & ~is_ground & ~found

    # --- update region table -------------------------------------------------
    rid = _one(region_id)
    old_h = state.region_height[rid][0]
    old_w = state.region_weight[rid][0]
    merged_h = (old_h * old_w * cfg.temporal_inertia + h) \
        / (old_w * cfg.temporal_inertia + 1.0)
    upd_h = torch.where(allocate, h, merged_h)
    upd_w = torch.where(allocate, torch.full_like(old_w, 10.0), old_w + 1.0)

    region_height = torch.where(
        do_update, state.region_height.index_put((rid,), upd_h[None]),
        state.region_height)
    region_weight = torch.where(
        do_update, state.region_weight.index_put((rid,), upd_w[None]),
        state.region_weight)
    n_regions = torch.where(
        allocate, torch.clamp(state.n_regions + 1, max=cfg.max_regions),
        state.n_regions)

    # --- merge patch into maps ------------------------------------------------
    conf_new = _diffuse_confidence(cfg, dtype, dev)
    keep_old = conf_old > conf_new
    region_merge = torch.where(keep_old, region_old, region_id)
    conf_merge = torch.maximum(conf_old, conf_new)

    region_map = state.region_map.index_put(
        (rows, cols), torch.where(do_update, region_merge, region_old))
    confidence = state.confidence.index_put(
        (rows, cols), torch.where(do_update, conf_merge, conf_old))

    # height correction for the root: the region under the center cell
    center_region = region_map[_one(torch.clamp(ci, 0, G - 1)),
                               _one(torch.clamp(cj, 0, G - 1))]
    correction = torch.where(do_update, region_height[center_region][0] - h,
                             torch.zeros_like(h))

    new_state = TerrainState(region_map=region_map, confidence=confidence,
                             region_height=region_height,
                             region_weight=region_weight, n_regions=n_regions)
    return new_state, correction


def height_field(state: TerrainState) -> torch.Tensor:
    """Dense (G, G) height map for rendering."""
    return state.region_height[state.region_map]
