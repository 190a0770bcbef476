"""Tools of the port: measurement scripts run on the GPU."""
