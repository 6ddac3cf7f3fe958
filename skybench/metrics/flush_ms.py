"""The engine's ``last_flush_ms`` (the trigger-time flush, the card
synchronised), mean over the measured window's triggers; read for every
``flush_ms.<suffix>`` metric that has no file of its own."""


def read(run):
    if not run.flush_ms:
        return None
    return sum(run.flush_ms) / len(run.flush_ms)
