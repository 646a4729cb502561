"""The benchmark's harness: finds a cell's files by name, runs the
program's path for it (:mod:`portbench.harness.families`), times the
window, reads the trace and checks the output against the plain
reference (:mod:`portbench.reference`)."""
