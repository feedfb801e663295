"""Plain reference computations of the benchmark: no import of the program
under test."""
