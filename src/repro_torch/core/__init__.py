"""The port's copies of the paper's cores (pure Python and numpy): the cost
model (``costmodel``), the HBP program IR (``hbp``), the simulated multicore
(``machine``), the data layouts (``layouts``), the access-trace programs
(``algorithms``), the schedulers with the rounds the launchers share
(``pws.PWS`` / ``pws.match_round``, ``rws.RWS`` / ``rws.two_choice``) and
the value-level algorithms on tensors (``algorithms_torch``)."""
