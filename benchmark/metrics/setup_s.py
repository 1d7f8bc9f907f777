"""Set-up seconds: the process's start to the window's start (imports,
the device, kernel builds on a first run, inputs, the port's plans and
model, warm-up)."""


def read(rec):
    return rec["setup_s"]
