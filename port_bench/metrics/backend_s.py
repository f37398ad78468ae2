"""Mean synchronised seconds per terminate_eva call of its two backend
runs (update_lowmem's chunks through K2 + K3, the global Video.ba)."""
UNIT, BETTER, LAYER = "s", "lower", "backend"


def read(rec):
    s = rec.spans.get("backend")
    return sum(s) / len(s) if s else None
