"""The harness's library: cells by name, the NVML counter, the table of
peaks, closed-form operation counts and the reduction of device traces."""
