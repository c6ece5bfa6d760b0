"""Scheduling cores shared by the port's launchers (``pws.match_round``,
``rws.two_choice``)."""
