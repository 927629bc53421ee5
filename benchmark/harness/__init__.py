"""General code of the benchmark: BENCHMARK.json and its rules (`spec`), the
system under test (`system`), traffic (`traffic`), the loops that drive
it (`loops`), the device trace (`trace`), the comparison that decides
`correct` (`check`) and one run of a cell (`cell`)."""
