"""Host-side cryptography: native AES-256-GCM, versioned keys, rotation."""
