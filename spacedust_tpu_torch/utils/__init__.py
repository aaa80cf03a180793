"""Runtime utilities: leveled logging, timers, artifact cache."""
