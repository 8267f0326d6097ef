"""Resilience (`repro/resilience/`): elastic replica membership,
deterministic fault plans (by replica or by topology node), and the
supervisor that replays a plan on the simulated clock with full-state
checkpoints. The live health / regroup plane for real process death
(`repro/resilience/runtime.py`) is ROADMAP item 16."""
from repro_torch.resilience.faults import KINDS, FaultEvent, FaultPlan
from repro_torch.resilience.membership import donor_mean_rows, reseed_carry
from repro_torch.resilience.supervisor import ResilienceReport, run_with_faults

__all__ = ["KINDS", "FaultEvent", "FaultPlan", "donor_mean_rows", "reseed_carry",
           "ResilienceReport", "run_with_faults"]
