"""Anchor densification on the padded pools (port of
`contextgs_tpu/models/densify.py`).

Growing activates free slots of the pool, in index order, with zeroed Adam
moments and statistics; pruning clears the alive bit. If a growth round
yields more anchors than free slots the excess is dropped and `overflowed`
is set, so that the training loop enlarges the pool before the next round.

Growing is the reference's 3-depth multi-resolution scheme: candidates are
gaussians whose accumulated screen-gradient exceeds 2^i · threshold, kept
with probability 1−0.5^(i+1), voxelized at voxel_size · update_init_factor /
update_hierachy_factor^i and deduplicated against occupied anchor voxels;
new anchors take the voxel-max feature and hyper latent of their candidates.
The random draws all come from `keep_draws`, so a test can hand both
packages the same numbers.

Under a process group (`group`, the counterpart of the reference's
`gather_axis`), each rank grows into its own free slots, and the candidate
voxels are deduplicated against the anchors of every rank: their voxel keys
and `alive` are all-gathered at each depth.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contextgs_tpu_torch.config import ModelConfig, OptimizationConfig
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.levels import segmented_carry
from contextgs_tpu_torch.models.state import Buffers, Params
from contextgs_tpu_torch.train.optim import AdamState
from contextgs_tpu_torch.utils import trace


def accumulate_stats(buffers: Buffers, neural_opacity: torch.Tensor,
                     gauss_valid: torch.Tensor, radii_pos: torch.Tensor,
                     anchor_visible: torch.Tensor, screen_grad: torch.Tensor,
                     n_offsets: int) -> Buffers:
    """neural_opacity/gauss_valid/radii_pos/screen_grad are [N·K] slot
    tensors; anchor_visible is [N]."""
    n = anchor_visible.shape[0]
    op = torch.clamp(neural_opacity, min=0.0).reshape(n, n_offsets)
    vis = anchor_visible
    opacity_accum = buffers.opacity_accum + torch.where(vis, op.sum(1), 0.0)
    anchor_denom = buffers.anchor_denom + vis.to(torch.float32)
    update = (gauss_valid & radii_pos).reshape(n, n_offsets)
    gnorm = torch.linalg.norm(screen_grad[:, :2], dim=-1).reshape(n, n_offsets)
    return buffers._replace(
        opacity_accum=opacity_accum, anchor_denom=anchor_denom,
        offset_grad_accum=buffers.offset_grad_accum
        + torch.where(update, gnorm, 0.0),
        offset_denom=buffers.offset_denom + update.to(torch.float32))


def _sorted_groups(keys3: torch.Tensor, valid: torch.Tensor,
                   prio: torch.Tensor, with_leader_prio: bool = False):
    """Group elements by voxel key; return per element (group_id,
    is_group_leader, leader_prio); leader_prio is carried only
    `with_leader_prio`, and is None otherwise. Groups are numbered in
    lexicographic key order, the leader is the member with the smallest
    `prio`, and invalid elements form one sentinel group."""
    n = keys3.shape[0]
    keys = torch.where(valid[:, None], keys3, 2 ** 30)
    order = torch.arange(n, device=keys3.device)
    for key in (prio, keys[:, 2], keys[:, 1], keys[:, 0]):  # least first
        order = order[torch.sort(key[order], stable=True).indices]
    sk = keys[order]
    new_group = torch.ones(n, dtype=torch.bool, device=keys3.device)
    new_group[1:] = (sk[1:] != sk[:-1]).any(1)
    gid = torch.empty_like(order)
    gid[order] = torch.cumsum(new_group, 0) - 1
    is_leader = torch.empty_like(new_group)
    is_leader[order] = new_group
    if not with_leader_prio:
        return gid, is_leader, None
    leader_prio = torch.empty_like(prio)
    leader_prio[order] = segmented_carry(new_group, prio[order])
    return gid, is_leader, leader_prio


def _voxel_occupied(cand_keys: torch.Tensor, cand_valid: torch.Tensor,
                    anchor_keys: torch.Tensor, anchor_valid: torch.Tensor):
    """For each candidate, is its voxel occupied by any valid anchor? In a
    joint grouping anchors (flag 0) lead their voxel, so a candidate's voxel
    is occupied iff its group leader is an anchor."""
    na = anchor_keys.shape[0]
    flag = torch.cat([
        torch.zeros(na, dtype=torch.int32, device=cand_keys.device),
        torch.ones(cand_keys.shape[0], dtype=torch.int32,
                   device=cand_keys.device)])
    _, _, leader_flag = _sorted_groups(
        torch.cat([anchor_keys, cand_keys]),
        torch.cat([anchor_valid, cand_valid]), flag, with_leader_prio=True)
    return (leader_flag[na:] == 0) & cand_valid


def keep_draws(generator: torch.Generator | None, depth: int, nk: int,
               device) -> torch.Tensor:
    """[depth, N·K] U[0,1) draws that keep growth candidates, one row per
    depth: every random number densification uses."""
    return torch.rand((depth, nk), generator=generator, dtype=torch.float32,
                      device=device)


class DensifyResult(NamedTuple):
    params: Params
    buffers: Buffers
    adam: AdamState
    n_grown: torch.Tensor
    n_pruned: torch.Tensor
    overflowed: torch.Tensor


def _group_max(values: torch.Tensor, group: torch.Tensor, rows: torch.Tensor):
    """Per row of `rows`, the max of `values` over the members of its
    group (members: the elements `values` lists, groups `group`)."""
    with trace.sync("densify.unique"):
        uniq, inv = torch.unique(group, return_inverse=True)
    out = torch.full((uniq.numel(), values.shape[1]), -1e30,
                     dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, inv[:, None].expand_as(values), values, "amax")
    return out[torch.searchsorted(uniq, rows)]


@torch.no_grad()
def adjust_anchors(params: Params, buffers: Buffers, adam: AdamState,
                   cfg: ModelConfig, opt: OptimizationConfig,
                   voxel_size: float,
                   generator: torch.Generator | None = None,
                   group=None, draws: torch.Tensor | None = None
                   ) -> DensifyResult:
    """Grow, reset statistics, prune. The anchor fields of `params` and the
    Adam moments are written in place (the pool is the model's largest
    state); the buffers are new tensors. `draws` ([update_depth, N·K], as
    `keep_draws` gives them) replace the generator's; with `group` (a
    `parallel.comm.Comm`) the occupied voxels are every rank's."""
    n, k = params.offsets.shape[0], cfg.n_offsets
    nk = n * k
    dev = params.anchor.device
    f32 = dict(dtype=torch.float32, device=dev)

    grads = buffers.offset_grad_accum / buffers.offset_denom
    grads = torch.nan_to_num(grads, nan=0.0, posinf=0.0).reshape(nk)
    offset_mask = (buffers.offset_denom.reshape(nk)
                   > opt.update_interval * opt.success_threshold * 0.5)

    alive = buffers.alive
    opacity_accum, anchor_denom = buffers.opacity_accum, buffers.anchor_denom
    offset_grad_accum = buffers.offset_grad_accum
    offset_denom = buffers.offset_denom
    total_grown = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if draws is None:
        draws = keep_draws(generator, cfg.update_depth, nk, dev)
    slot = torch.arange(nk, dtype=torch.int32, device=dev)
    # the new anchors' constants are filled on the device: a copy from host
    # memory (a tensor of host values, or a Python number written into rows)
    # would wait for it
    unit_rotation = torch.eye(1, 4, **f32)
    opacity_init = torch.log(torch.full((), 0.1 / 0.9, **f32))

    for i in range(cfg.update_depth):
        with trace.span("densify/grow"):
            thr = (opt.densify_grad_threshold
                   * ((cfg.update_hierachy_factor // 2) ** i))
            size_factor = (cfg.update_init_factor
                           // (cfg.update_hierachy_factor ** i))
            cur_size = torch.full((), voxel_size * size_factor, **f32)

            cand = ((grads >= thr) & offset_mask
                    & (draws[i] > 0.5 ** (i + 1))
                    & alive.repeat_interleave(k))
            anchor_q = st.get_anchor(params, buffers)
            scaling3 = st.get_scaling(params)[:, :3]
            all_xyz = (anchor_q[:, None, :]
                       + params.offsets * scaling3[:, None, :]).reshape(nk, 3)
            cand_keys = torch.round(all_xyz / cur_size).to(torch.int32)
            anchor_keys = torch.round(anchor_q / cur_size).to(torch.int32)

            gid, is_leader, _ = _sorted_groups(cand_keys, cand, slot)
            occ_keys, occ_valid = anchor_keys, alive
            if group is not None:
                occ_keys = group.all_gather(anchor_keys)
                occ_valid = group.all_gather(alive)
            occupied = _voxel_occupied(cand_keys, cand, occ_keys, occ_valid)
            # a group is occupied iff any member is (same voxel)
            occ_per_group = torch.zeros(nk, dtype=torch.int32, device=dev)
            occ_per_group.scatter_reduce_(0, gid, occupied.to(torch.int32),
                                          "amax")
            new_leader = cand & is_leader & (occ_per_group[gid] == 0)

            # allocate free slots in index order
            free_order = torch.argsort(alive.to(torch.int32), stable=True)
            n_free = (~alive).sum()
            rank = torch.cumsum(new_leader, 0) - 1
            can_place = new_leader & (rank < n_free)
            overflow |= (new_leader & (rank >= n_free)).any()
            with trace.sync("densify.placed"):
                src = torch.nonzero(can_place).squeeze(1)
            dest = free_order[rank[src]]

            # voxel-max feature/hyper over the candidates of the group
            with trace.sync("densify.members"):
                members = torch.nonzero(cand).squeeze(1)
            for name in ("anchor_feat", "hyper_latent"):
                leaf = getattr(params, name)
                leaf[dest] = _group_max(leaf[members // k], gid[members],
                                        gid[src])
            params.anchor[dest] = cand_keys[src].to(torch.float32) * cur_size
            params.offsets.index_fill_(0, dest, 0.0)
            params.mask_logit.index_fill_(0, dest, 1.0)
            params.scaling_log[dest] = torch.log(cur_size)
            params.rotation[dest] = unit_rotation
            params.opacity_raw[dest] = opacity_init
            placed = torch.zeros(n, dtype=torch.bool, device=dev).index_fill_(
                0, dest, True)
            alive = alive | placed
            # zero Adam moments and stats of activated slots
            for moments in (adam.mu, adam.nu):
                for name in st.ANCHOR_FIELDS:
                    moments[name][placed] = 0.0
            opacity_accum = torch.where(placed, 0.0, opacity_accum)
            anchor_denom = torch.where(placed, 0.0, anchor_denom)
            offset_grad_accum = torch.where(placed[:, None], 0.0,
                                            offset_grad_accum)
            offset_denom = torch.where(placed[:, None], 0.0, offset_denom)
            total_grown = total_grown + can_place.sum()

    with trace.span("densify/prune"):
        # reset offset stats where they were consumed
        om = offset_mask.reshape(n, k)
        offset_denom = torch.where(om, 0.0, offset_denom)
        offset_grad_accum = torch.where(om, 0.0, offset_grad_accum)

        # prune; anchors with enough observations get their opacity stats
        # reset
        enough = anchor_denom > opt.update_interval * opt.success_threshold
        prune = ((opacity_accum < opt.min_opacity * anchor_denom) & enough
                 & alive)
        opacity_accum = torch.where(enough, 0.0, opacity_accum)
        anchor_denom = torch.where(enough, 0.0, anchor_denom)
        alive = alive & ~prune
        offset_grad_accum = torch.where(prune[:, None], 0.0,
                                        offset_grad_accum)
        offset_denom = torch.where(prune[:, None], 0.0, offset_denom)

        # survivors' gaussian log-scales are clamped at 0.05 on every round
        params.scaling_log[:, 3:].clamp_(max=0.05)

    buffers = buffers._replace(
        alive=alive, opacity_accum=opacity_accum, anchor_denom=anchor_denom,
        offset_grad_accum=offset_grad_accum, offset_denom=offset_denom)
    return DensifyResult(params=params, buffers=buffers, adam=adam,
                         n_grown=total_grown, n_pruned=prune.sum(),
                         overflowed=overflow)
