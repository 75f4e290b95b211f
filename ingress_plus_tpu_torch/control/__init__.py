"""Control plane: tenant rule-tag tables (sync.py) and the guarded
ruleset rollout (rollout.py)."""
