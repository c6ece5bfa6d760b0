"""Runtime policy for the port's launchers: fault injection, bounded retry
and straggler detection (``fault_tolerance``)."""
