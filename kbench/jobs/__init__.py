"""Job modules: one module a job kind, named by a traffic file's `job`."""
