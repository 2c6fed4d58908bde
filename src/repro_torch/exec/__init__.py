"""Query execution: planner, candidate/score/merge stages and the executor."""
