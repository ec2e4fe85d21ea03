"""`wide_route_share.solve`: the share of the traced rounds' ``count_stats``
launches that took the wide route (w > 32 words a row), from the
program's launch counters (``count_stats.wide`` over ``count_stats`` in
``_build.LAUNCHES``).  Nothing where the program counts no routes."""


def read(r):
    launches = (r.get("profile") or {}).get("launches") or {}
    wide, total = launches.get("count_stats.wide"), launches.get("count_stats")
    if wide is None or not total:
        return None
    return wide / total
