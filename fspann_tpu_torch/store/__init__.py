"""Host-side persistence: ciphertext arenas + append-only metadata log."""
