"""Requests of every kind completed in the window, a second."""


def read(run):
    return run["requests"] / run["seconds"]
