"""Launch layer of the port: serving (``serve``) on one GPU."""
