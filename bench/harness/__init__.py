"""The benchmark's yardstick: catalog, traffic, weights, drivers, trace
reading, the judge and the FLOP arithmetic."""
