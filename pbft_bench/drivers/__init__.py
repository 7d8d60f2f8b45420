"""Traffic drivers, named by a mix's `driver` key: `flood` sends signed
sweeps straight to the program's verify service, `committee` sends
client requests through a committee."""
