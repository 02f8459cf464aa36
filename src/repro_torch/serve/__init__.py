"""Serving: Scheduler / KVCacheManager / Session behind the Engine facade."""
