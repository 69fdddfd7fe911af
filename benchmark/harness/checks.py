"""The verdict: each compared number beside its limit; a run is correct
when every number is within its limit."""


def checks_of(numbers: dict, limits: dict) -> dict:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
