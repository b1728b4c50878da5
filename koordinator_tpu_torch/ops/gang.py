"""Coscheduling (gang) feasibility as segment sums, in torch.

Reference: `pkg/scheduler/plugins/coscheduling/` — PreFilter rejects members
of an invalid gang (a host precompute: fewer known members than minMember);
Permit holds assigned members until every gang of the gang-group reaches
minMember. Batched, Permit is a post-pass after the serial round: count
tentative assignments per gang, check count + already-assumed >= minMember,
AND across each gang-group, strike the members of failed groups. Capacity
held by struck pods is not rolled back in the round (waiting pods hold their
reservation in the reference too); the host applies only surviving bindings.
"""

from __future__ import annotations

import numpy as np
import torch


def gang_permit_mask(
    chosen: torch.Tensor,           # [P] int32 node index or -1
    gang_id: torch.Tensor,          # [P] int32, -1 = not in a gang
    gang_min_member: torch.Tensor,  # [NG]
    gang_assumed: torch.Tensor,     # [NG] members assumed/bound before batch
    gang_group_id: torch.Tensor,    # [NG] int32 gang-group
    num_gangs: int,
    num_groups: int,
) -> torch.Tensor:
    """[P] bool: keep binding after the Permit barrier. The sums are 0/1
    counts, so index_add_ is exact in any order."""
    dev = chosen.device
    in_gang = gang_id >= 0
    gid = torch.clamp_min(gang_id, 0).long()
    assigned = (chosen >= 0) & in_gang
    per_gang = torch.zeros(num_gangs, dtype=torch.float32, device=dev)
    per_gang.index_add_(0, gid, assigned.to(torch.float32))
    gang_ok = per_gang + gang_assumed >= gang_min_member
    # all gangs in a gang-group must pass (core.go:311-338)
    grp = gang_group_id.long()
    group_fail = torch.zeros(num_groups, dtype=torch.float32, device=dev)
    group_fail.index_add_(0, grp, (~gang_ok).to(torch.float32))
    keep_gang = gang_ok & (group_fail[grp] == 0)
    return torch.where(in_gang, keep_gang[gid], True)


def gang_prefilter_valid(
    gang_total_members: np.ndarray,  # [NG] pods known to the gang (cache)
    gang_min_member: np.ndarray,     # [NG]
) -> np.ndarray:
    """[NG] bool host precompute: gang invalid when fewer known members than
    minMember (core/gang.go state machine)."""
    return gang_total_members >= gang_min_member
