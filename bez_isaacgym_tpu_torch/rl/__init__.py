"""Policy networks and players (checkpoint inference)."""
