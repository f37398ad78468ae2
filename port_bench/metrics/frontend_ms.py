"""Mean synchronised milliseconds of droid.frontend() per frame of the
window (edge selection, update_fused's rounds: the update operator,
K4/K5, K1 and the BA solve)."""
UNIT, BETTER, LAYER = "ms", "lower", "frontend"


def read(rec):
    s = rec.spans.get("frontend")
    return 1e3 * sum(s) / len(s) if s else None
