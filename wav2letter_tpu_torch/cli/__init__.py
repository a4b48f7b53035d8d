def pop_device(args):
    """(``--device``'s value, default ``cuda``; the other arguments)."""
    device, rest = "cuda", []
    for a in args:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def _typed(d, v):
    if isinstance(d, bool):
        return v.lower() in ("true", "1", "")
    if isinstance(d, int):
        return int(float(v))
    if isinstance(d, float):
        return float(v)
    return v


def parse_typed(args, defaults, coerce=_typed):
    """Split ``--flag=value`` arguments into the others (a list) and those
    named in ``defaults`` (a dict): ``coerce(default, text)`` gives a flag's
    value, by default typed by its default."""
    argv, flags = [], {}
    for a in args:
        if a.startswith("--"):
            k = a[2:].split("=", 1)[0]
            if k in defaults:
                flags[k] = coerce(defaults[k], a.split("=", 1)[1] if "=" in a else "true")
                continue
        argv.append(a)
    return argv, flags
