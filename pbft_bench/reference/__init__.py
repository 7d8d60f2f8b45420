"""The benchmark's plain references: Ed25519 verification (`ed25519`)
and a key-value store that applies committed requests (`kv`). Neither
imports the program or JAX."""
