"""setup_s: seconds from the process's start to the window's start
(imports, the scene, the kernel's build on a checkout's first run, the
kind's warm-up or first steps)."""


def read(run):
    return run["setup_s"]
