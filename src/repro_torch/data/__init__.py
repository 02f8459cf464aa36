"""Input pipeline: the synthetic token stream and its prefetcher."""
