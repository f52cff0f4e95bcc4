"""Mean over the window's queries of |returned ids & exact 10-NN| / 10."""


def read(run):
    return run["recall_at_10"] if run["queries"] else None
