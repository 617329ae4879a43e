"""Mean ``store.seal`` time per ``insert_live`` call of the window: the store's
AES-GCM seal of the new payloads, in ms."""

from bench_torch.program_spans import insert_phase


def read(run):
    return insert_phase(run, "store.seal")
