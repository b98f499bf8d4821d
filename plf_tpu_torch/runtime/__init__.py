"""Host runtime of the port: the streaming executor and the native golden
oracle."""
