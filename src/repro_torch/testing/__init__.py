"""Testing utilities: the seeded fault-injection harness of the
resilience layer (counterpart of ``repro.testing``)."""
from repro_torch.testing.faults import (FAULT_MODES, BitFlipFault,
                                        CompileFault, InjectedFault,
                                        NaNFault, ProcessKillFault,
                                        RunnerExceptionFault,
                                        SimulatedProcessDeath,
                                        SparseOverflowFault,
                                        StaleUpdateFault, make_fault)

__all__ = ["FAULT_MODES", "make_fault", "InjectedFault",
           "SimulatedProcessDeath", "NaNFault", "BitFlipFault",
           "StaleUpdateFault", "RunnerExceptionFault", "SparseOverflowFault",
           "CompileFault", "ProcessKillFault"]
