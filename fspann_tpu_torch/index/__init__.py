"""Scan-mode routing index: host encode, device-resident scan state."""
