"""Shots decoded and counted in the window over the window's whole time."""


def read(run):
    return run.shots / run.window_s if run.window_s else None
