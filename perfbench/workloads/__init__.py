"""Runners of the traffic kinds: one general runner per kind, which a
traffic file under ``traffic/`` names in its ``kind`` and parameterises."""
