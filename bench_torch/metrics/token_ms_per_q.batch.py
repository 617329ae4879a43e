"""Mean ``token.create`` time per query (batch requests): the client's
LSH encode, AES seal, digests and token objects, in ms."""

from bench_torch.program_spans import token_ms_per_q


def read(run):
    return token_ms_per_q(run, "batch")
