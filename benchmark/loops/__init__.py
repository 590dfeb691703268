"""The loops that traffic mixes name: what one step is, what input it
takes and how many images it completes."""
