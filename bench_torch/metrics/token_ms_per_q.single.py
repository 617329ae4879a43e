"""Mean ``token.create`` time per query (single requests): the client's
LSH encode, AES seal, digest and token object, in ms."""

from bench_torch.program_spans import token_ms_per_q


def read(run):
    return token_ms_per_q(run, "single")
