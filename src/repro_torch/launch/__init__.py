"""Launchers: the lockstep server, the continuous-batching engine and the
trainer."""
