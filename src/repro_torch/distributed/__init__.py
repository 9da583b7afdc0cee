from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     StragglerMonitor,
                                                     SimulatedFailure)
