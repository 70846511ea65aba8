"""One driver a kind of traffic: ``run(r: harness.Run) -> harness.Outcome``."""
