"""One module a kind of traffic, found by the traffic file's ``kind``
(`spec.kind_module`): it runs a cell of that kind from set-up to verdict
(``run(cell, seed, seconds, traced, device, t_start)``) and returns what
`benchmark.run` reports."""
