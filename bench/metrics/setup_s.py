"""Seconds from the process's start to the window's: loading, making the inputs,
preparing DCI's caches (presampling, Eq. 1, the fill), building the kernels on a first
run, and warming the cell's shapes."""


def read(ctx):
    return ctx["setup_s"]
