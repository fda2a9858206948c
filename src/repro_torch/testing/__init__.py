"""Testing utilities: the seeded fault-injection harness of the
resilience layer and the gateway (counterpart of ``repro.testing``)."""
from repro_torch.testing.faults import (FAULT_MODES, BitFlipFault,
                                        CompileFault, GatewayKillFault,
                                        InjectedFault, NaNFault,
                                        ProcessKillFault,
                                        RunnerExceptionFault,
                                        SimulatedProcessDeath,
                                        SliceExceptionFault,
                                        SliceFaultInjector, SliceNaNFault,
                                        SparseOverflowFault,
                                        StaleUpdateFault, make_fault)

__all__ = ["FAULT_MODES", "make_fault", "InjectedFault",
           "SimulatedProcessDeath", "NaNFault", "BitFlipFault",
           "StaleUpdateFault", "RunnerExceptionFault", "SparseOverflowFault",
           "CompileFault", "ProcessKillFault", "SliceFaultInjector",
           "SliceExceptionFault", "SliceNaNFault", "GatewayKillFault"]
