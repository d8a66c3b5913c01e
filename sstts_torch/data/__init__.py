"""Text front-end (a copy of `sstts.data.text`)."""
