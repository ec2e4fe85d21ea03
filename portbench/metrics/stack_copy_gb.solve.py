"""`stack_copy_gb.solve`: gigabytes (10^9 bytes) a traced round that the
engine steps' stack clones allocate and write, from the program's
``stack_push_bytes`` counter in ``_build.LAUNCHES``.  Nothing where the
program has no such counter."""


def read(r):
    p = r.get("profile") or {}
    copied = (p.get("launches") or {}).get("stack_push_bytes")
    if copied is None or not p.get("rounds"):
        return None
    return copied / p["rounds"] / 1e9
