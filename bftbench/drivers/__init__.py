"""Drivers: each runs one path of the program, named by a configuration's
`driver`."""


def verdict(e: ValueError) -> tuple:
    """(error type, height, lane) of a refusal; -1 where it names none."""
    return (type(e).__name__, getattr(e, "height", -1),
            getattr(e, "lane", -1))
