"""Runtime policy for the port's launchers: fault injection, bounded retry,
straggler detection and the trainer's fault-tolerant runner
(``fault_tolerance``)."""
