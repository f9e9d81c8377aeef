"""The port's parallel-config zoo (its scripts run by path from this
directory; see ``README.md``)."""
