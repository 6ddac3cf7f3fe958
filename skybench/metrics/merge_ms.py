"""The engine's ``last_merge_ms`` (the global merge's launch and harvest),
mean over the measured window's answers; read for every
``merge_ms.<suffix>`` metric that has no file of its own."""


def read(run):
    if not run.merge_ms:
        return None
    return sum(run.merge_ms) / len(run.merge_ms)
