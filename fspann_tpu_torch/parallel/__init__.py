"""Scale-out: corpus-sharded routing + top-k merge over the shards."""
