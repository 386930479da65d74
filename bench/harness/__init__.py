"""The benchmark's yardstick: inputs, arithmetic, counts and readings
that the program under test cannot change."""
