"""Share of the inputs' wall time outside their batch calls (each batch
call ended by a synchronise), in %: the container layer's framing,
segment reading and batching."""


def read(rec):
    ins = rec.get("inputs")
    if not ins:
        return None
    wall = sum(i["wall"] for i in ins)
    return 100.0 * (wall - sum(i["batch"] for i in ins)) / wall
