"""Host-side (numpy) workload generators: Zipf sampling and YCSB streams."""
