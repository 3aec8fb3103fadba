"""Traffic kinds: the code that sends each kind of traffic a traffic file names by its ``kind``."""
