"""Traffic drivers, one file each, found by the `driver` a traffic file
names."""
