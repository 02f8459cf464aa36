"""Memory tiers, spill codecs and the MemoryRuntime facade."""
