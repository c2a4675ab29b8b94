"""Seconds of the build's relaxation (FIRE, Langevin, retile) on its own
engine, host clock between two synchronises: the part of setup_s that
the configuration's depth sets."""


def read(tr, ctx, run):
    return ctx.notes.get("relax_s")
