"""Programs around the port: ``profile_frontend`` times the frontend's
sections at bench.py's shape."""
