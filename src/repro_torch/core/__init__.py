"""Framework-neutral core of the port: expressions, enumeration, FLOPs,
anomaly classification, fingerprints, execution backends and the sweep."""
