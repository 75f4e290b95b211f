"""Control-plane pieces the serve plane needs (tenant rule-tag tables)."""
