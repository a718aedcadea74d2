"""setup_s: seconds from the process's start to the window's first send
(imports, weights drawn on the card, engines, kernel libraries loaded or
built, warm-up)."""


def read(run):
    return run["setup_s"]
