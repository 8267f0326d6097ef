"""Resilience (`repro/resilience/`): elastic replica membership,
deterministic fault plans (by replica or by topology node), and the
supervisor that replays a plan on the simulated clock with full-state
checkpoints, and (`runtime`) the live health / regroup plane for a real
process death in a multi-process run (`repro/resilience/runtime.py`)."""
from repro_torch.resilience.faults import KINDS, FaultEvent, FaultPlan
from repro_torch.resilience.membership import donor_mean_rows, reseed_carry
from repro_torch.resilience.supervisor import ResilienceReport, run_with_faults

__all__ = ["KINDS", "FaultEvent", "FaultPlan", "donor_mean_rows", "reseed_carry",
           "ResilienceReport", "run_with_faults"]
