"""Mean synchronised seconds per terminate_eva call of droid.traj_filler."""
UNIT, BETTER, LAYER = "s", "lower", "trajectory filler"


def read(rec):
    s = rec.spans.get("filler")
    return sum(s) / len(s) if s else None
